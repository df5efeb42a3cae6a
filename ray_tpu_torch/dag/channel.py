"""Seqno-gated SPSC shm channel, and the device lane on top of it.

The port's copy of ``ray_tpu/dag/channel.py``. Layout inside one sealed
store object (mutable by convention — the mapping is shared read-write,
the seal only fixes the allocation)::

    ChanHeader { seqno, ack, len, per-channel pshared mutex+cond }
    ...  payload (serialized container, <= capacity)

Single writer, single reader. The writer blocks until the previous message
is acked (rendezvous semantics, like the reference's mutable-object
channels, python/ray/experimental/channel/shared_memory_channel.py:147);
the reader blocks on seqno. Per-channel synchronization means a post wakes
exactly the peer — pipeline hops cost microseconds. Both sides use timed
waits so a dead peer surfaces as a timeout rather than a deadlock.

Torch tensors on a plain shm edge follow the runtime's rule
(``core/serialization.py``): a tensor is pickled as its dtype, shape and
bytes, and a CUDA tensor is copied to the host on the way, so it arrives
as a CPU tensor and the receiver moves it where it wants it. A CPU-only
stage (a worker with ``CUDA_VISIBLE_DEVICES=""``) therefore reads what a
GPU stage wrote. Tensors that stay on the card cross a
:class:`DeviceChannel`, which needs both stages in one process.

Cross-node edges (``SocketChannel`` in the reference) need cluster mode's
authkey and come with it (ROADMAP.md section 1, item 5).
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
from typing import Any, Tuple

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.util.debug_lock import make_lock


def _tensor_table():
    """The runtime's tensor reducer as a pickler dispatch table, once
    torch is loaded (this module never imports it); None before."""
    from ray_tpu_torch.core import serialization

    torch = serialization.loaded_torch()
    if torch is None:
        return None
    return {torch.Tensor: serialization._reduce_tensor}


def _chan_dumps(value: Any) -> bytes:
    table = _tensor_table()
    try:
        if table is None:
            return pickle.dumps(value, protocol=5)
        with io.BytesIO() as f:
            p = pickle.Pickler(f, protocol=5)
            p.dispatch_table = table
            p.dump(value)
            return f.getvalue()
    except Exception:  # noqa: BLE001 — closures etc.: cloudpickle path
        from ray_tpu_torch.core import serialization

        # cloudpickle with the same tensor reducer; no buffer callback,
        # so every buffer is pickled in band
        return serialization._dumps(value, None)


_SEQ = 0  # counter index: writer publishes
_ACK = 1  # counter index: reader consumed


class ChannelClosed(Exception):
    pass


_CLOSE_LEN = (1 << 64) - 1  # len sentinel marking a closed channel


class Channel:
    """One endpoint of an SPSC channel (create on the writer side, open
    from a descriptor anywhere attached to the same store)."""

    def __init__(self, store, oid: ObjectID, capacity: int,
                 spin_us: int = 0):
        self._store = store
        self._oid = oid
        self._capacity = capacity
        self._offset = store.object_offset(oid)  # pins the object
        self._hdr = store.chan_header_size()
        self._seq = 0   # last seqno this endpoint saw/wrote
        # busy-poll budget before the condvar fallback (0 = pure block);
        # carried in the descriptor so BOTH endpoints of a hot edge spin
        self._spin_us = int(spin_us)

    # -- construction --------------------------------------------------------

    @classmethod
    def create(cls, store, capacity: int = 1 << 20,
               spin_us: int = 0) -> "Channel":
        oid = ObjectID.from_random()
        hdr = store.chan_header_size()
        store.create_object(oid, hdr + capacity)
        try:
            store.seal(oid)
            ch = cls(store, oid, capacity, spin_us)
            store.chan_init(ch._offset)
        except BaseException:
            # seal/pin/init failed mid-construction: abort the backing
            # object (drop the ref, then free) instead of stranding an
            # unsealed or unowned allocation until store close
            store.release(oid)
            store.delete(oid)
            raise
        return ch

    def descriptor(self) -> Tuple[str, bytes, int, int]:
        """Picklable descriptor; open with Channel.open on any process
        attached to the same store."""
        return ("shm", self._oid.binary(), self._capacity, self._spin_us)

    @classmethod
    def open(cls, store, desc) -> "Channel":
        _, oid, capacity, spin_us = desc
        return cls(store, ObjectID(oid), capacity, spin_us)

    def _wait(self, which: int, last: int, timeout_ms: int) -> int:
        if self._spin_us > 0:
            return self._store.chan_wait_spin(
                self._offset, which, last, timeout_ms, self._spin_us)
        return self._store.chan_wait(self._offset, which, last, timeout_ms)

    # -- data plane ----------------------------------------------------------

    def _set_len(self, n: int):
        struct.pack_into(
            "<Q", self._store.view(self._offset + 16, 8), 0, n)

    def _get_len(self) -> int:
        return struct.unpack(
            "<Q", self._store.view(self._offset + 16, 8))[0]

    def write(self, value: Any, timeout_ms: int = 10_000):
        """Serialize + publish; blocks until the reader acked the previous
        message. The data plane is the C pickler writing straight into the
        shm slot (a channel hop is latency-critical; the container format
        with OOB buffers buys nothing at message sizes a slot can hold),
        with cloudpickle as the fallback for closures/lambdas."""
        self.write_raw(_chan_dumps(value), timeout_ms)

    def write_raw(self, data: bytes, timeout_ms: int = 10_000):
        """Publish pre-pickled bytes (fan-out callers serialize ONCE)."""
        if len(data) > self._capacity:
            raise ValueError(
                f"channel message ({len(data)}B) exceeds capacity "
                f"({self._capacity}B)")
        # overwrite gate: previous message must be consumed
        if self._seq:
            acked = self._wait(_ACK, self._seq - 1, timeout_ms)
            if acked == 0:
                raise TimeoutError("channel reader did not ack in time")
        body = self._store.view(self._offset + self._hdr, len(data))
        body[:len(data)] = data
        self._set_len(len(data))
        self._seq += 1
        self._store.chan_post(self._offset, _SEQ, self._seq)

    def read(self, timeout_ms: int = 10_000) -> Any:
        """Block for the next message; deserializes a COPY (the slot is
        acked + reusable immediately after return)."""
        seq = self._wait(_SEQ, self._seq, timeout_ms)
        if seq == 0:
            raise TimeoutError("channel read timed out")
        self._seq = seq
        length = self._get_len()
        if length == _CLOSE_LEN:
            raise ChannelClosed
        value = pickle.loads(
            self._store.view(self._offset + self._hdr, length))
        # ack: the writer may overwrite now
        self._store.chan_post(self._offset, _ACK, seq)
        return value

    def close(self, timeout_ms: int = 5000):
        """Writer-side: wake the reader with a close sentinel. Respects the
        ack gate so an unconsumed in-flight message is never clobbered."""
        if self._seq:
            # best effort: a dead reader must not make close() hang
            self._wait(_ACK, self._seq - 1, timeout_ms)
        self._set_len(_CLOSE_LEN)
        self._seq += 1
        self._store.chan_post(self._offset, _SEQ, self._seq)

    def release(self):
        try:
            self._store.release(self._oid)
        except Exception:  # noqa: BLE001
            pass


# -- on-device channels -------------------------------------------------------
#
# Process-local handoff registry for DeviceChannel: torch tensors passed by
# REFERENCE between stages of the same process (bound methods of one GPU
# actor), keyed (channel oid bytes, seqno) so pipelined messages never
# collide. Only a tiny doorbell record crosses shm.
_DEVICE_HANDOFF: dict = {}
_DEVICE_HANDOFF_LOCK = make_lock("dag.device_handoff")


def _is_device_array(value: Any) -> bool:
    """True for a torch tensor (the payload DeviceChannel hands over by
    reference); anything else rides the inner pickled shm path. Never
    imports torch: a process that has not loaded it holds no tensor."""
    from ray_tpu_torch.core.serialization import loaded_torch

    torch = loaded_torch()
    return torch is not None and isinstance(value, torch.Tensor)


def _is_device_payload(value: Any) -> bool:
    """True when a stage payload can stay on device whole: a single
    tensor, or a non-empty tuple/list of tensors (multi-buffer handoffs
    like a KV page pair — pickling any element would defeat the edge)."""
    if _is_device_array(value):
        return True
    if isinstance(value, (tuple, list)) and value:
        return all(_is_device_array(v) for v in value)
    return False


def _tensors(payload) -> list:
    return [payload] if _is_device_array(payload) else list(payload)


def _record_events(payload) -> list:
    """(card, CUDA event) for each card the payload lies on, the event
    recorded on the writer's current stream there: the reader waits on
    it before it touches the tensors (two stages of one actor run in
    threads of their own and may be on other streams)."""
    torch = sys.modules["torch"]
    events = []
    for dev in {t.device for t in _tensors(payload) if t.is_cuda}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append((dev, ev))
    return events


def _adopt(payload, events) -> None:
    """Reader side of a device hop: the reader's current stream on each
    card waits for the writer's event, and every CUDA tensor is marked as
    used on that stream (``record_stream``), so the caching allocator
    does not hand its memory to the writer's stream while the reader's
    work may still read it."""
    if not events:
        return
    torch = sys.modules["torch"]
    for dev, ev in events:
        torch.cuda.current_stream(dev).wait_event(ev)
    for t in _tensors(payload):
        if t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))


class DeviceChannel:
    """DAG edge whose payload stays on the card: both stages are methods
    of the same GPU actor process, so the producer's output tensor (or
    tuple or list of tensors — e.g. a KV page pair from a disaggregated
    prefill) is handed off by reference through :data:`_DEVICE_HANDOFF`
    — donation semantics, the producer must not reuse the tensors after
    write — and only a ("d",) doorbell record crosses the inner shm
    channel. The consumer gets the producer's tensors themselves (the
    same ``data_ptr``), not copies.

    Each stage's loop runs in a thread of its own, so producer and
    consumer may be on different CUDA streams: the write records an
    event on the writer's current stream for each card the payload lies
    on, and the read makes the reader's current stream wait on it and
    ``record_stream``s each CUDA tensor there (the caching allocator then
    keeps the memory until the reader's work is done).

    Non-tensor payloads (host values, ("e", exc) error records, the close
    sentinel) pass through the inner channel unchanged, so the stage loop
    is oblivious to the edge type. Opening both endpoints in DIFFERENT
    processes is a compile-placement bug and surfaces as a RuntimeError
    at read time (the registry is process-local by design)."""

    def __init__(self, inner: "Channel"):
        self._inner = inner
        self._key = inner._oid.binary()

    @classmethod
    def create(cls, store, capacity: int = 1 << 20,
               spin_us: int = 0) -> "DeviceChannel":
        return cls(Channel.create(store, capacity, spin_us))

    def descriptor(self) -> Tuple[str, tuple]:
        return ("dev", self._inner.descriptor())

    @classmethod
    def open(cls, store, desc) -> "DeviceChannel":
        return cls(Channel.open(store, desc[1]))

    def write(self, value: Any, timeout_ms: int = 10_000):
        if (isinstance(value, tuple) and len(value) == 2
                and value[0] == "v" and _is_device_payload(value[1])):
            seq = self._inner._seq + 1
            entry = (value[1], _record_events(value[1]))
            with _DEVICE_HANDOFF_LOCK:
                _DEVICE_HANDOFF[(self._key, seq)] = entry
            try:
                self._inner.write(("d", None), timeout_ms)
            except BaseException:
                with _DEVICE_HANDOFF_LOCK:
                    _DEVICE_HANDOFF.pop((self._key, seq), None)
                raise
            return
        self._inner.write(value, timeout_ms)

    def read(self, timeout_ms: int = 10_000) -> Any:
        value = self._inner.read(timeout_ms)
        if isinstance(value, tuple) and len(value) == 2 \
                and value[0] == "d":
            with _DEVICE_HANDOFF_LOCK:
                entry = _DEVICE_HANDOFF.pop(
                    (self._key, self._inner._seq), None)
            if entry is None:
                raise RuntimeError(
                    "DeviceChannel doorbell with no device buffer: reader "
                    "and writer are not in the same process (compile "
                    "placement bug — device edges require both stages on "
                    "one actor)")
            payload, events = entry
            _adopt(payload, events)
            return ("v", payload)
        return value

    def close(self, timeout_ms: int = 5000):
        self._inner.close(timeout_ms)

    def release(self):
        with _DEVICE_HANDOFF_LOCK:
            for k in [k for k in _DEVICE_HANDOFF if k[0] == self._key]:
                del _DEVICE_HANDOFF[k]
        self._inner.release()


_SOCKET_REFUSAL = (
    "socket DAG channels (cross-node edges) are not ported yet: they need "
    "cluster mode's authkey (ROADMAP.md section 1, item 5)")


class SocketChannel:
    """The reference's SPSC channel over TCP for cross-node DAG edges:
    refused until the port's cluster mode (ROADMAP.md section 1, item 5)
    brings its authkey and rendezvous."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_SOCKET_REFUSAL)


def open_endpoint(desc, store=None):
    """Open either shm channel kind from its descriptor. A socket
    descriptor (a cross-node edge) raises NotImplementedError: socket
    channels come with cluster mode (ROADMAP.md section 1, item 5)."""
    if desc[0] == "sock":
        raise NotImplementedError(_SOCKET_REFUSAL)
    if store is None:
        raise RuntimeError("shm channel endpoint needs a store")
    if desc[0] == "dev":
        return DeviceChannel.open(store, desc)
    return Channel.open(store, desc)
