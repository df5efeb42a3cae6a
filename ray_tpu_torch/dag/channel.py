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

Cross-node edges ride a :class:`SocketChannel`: framed TCP with the same
rendezvous semantics, a mutual HMAC handshake on the cluster authkey,
and the reader's port published in the cluster KV. Its frames are the
same pickles as the shm channel's, so a CUDA tensor crosses it as a CPU
tensor too.
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


def _recv_n(conn, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ChannelClosed
        buf.extend(chunk)
    return bytes(buf)


def _mutual_auth(conn, authkey: bytes, role: str):
    """Mutual HMAC challenge/response keyed on the cluster authkey.

    Every other socket in the system (RpcServer, node/GCS links) rides
    multiprocessing.connection's authkey handshake; this gives DAG edges
    the same trust anchor so no unauthenticated peer can hijack an edge
    or feed the reader a crafted pickle. Both sides send their challenge
    first (no deadlock), then verify the peer's digest. The ROLE is bound
    into the MAC (reader answers with b"R"+challenge, expects b"W"+...)
    so a digest produced by one reader connection can never satisfy
    another reader connection's check — without this, two concurrent
    connections to the same reader form a reflection oracle."""
    import hashlib
    import hmac
    import os as _os

    my_tag, peer_tag = (b"R", b"W") if role == "reader" else (b"W", b"R")
    mine = _os.urandom(16)
    conn.sendall(mine)
    theirs = _recv_n(conn, 16)
    conn.sendall(hmac.new(authkey, my_tag + theirs,
                          hashlib.sha256).digest())
    answer = _recv_n(conn, 32)
    expect = hmac.new(authkey, peer_tag + mine, hashlib.sha256).digest()
    if not hmac.compare_digest(expect, answer):
        raise PermissionError("dag channel peer failed authkey handshake")


class SocketChannel:
    """SPSC channel over TCP for CROSS-NODE DAG edges (reference role:
    the multi-node channels of python/ray/experimental/channel/ — there
    NCCL/gRPC-backed, here a framed socket riding DCN).

    Rendezvous through the cluster KV: the READER binds an ephemeral port
    and publishes ``dagchan:<id> -> (host, port)``; the WRITER polls the
    key and connects. Connections complete a mutual HMAC handshake on the
    cluster authkey before any payload flows. Same rendezvous semantics as
    the shm channel: the writer blocks until the reader acked the previous
    message, so at most one message is in flight per edge and FIFO pairing
    is exact."""

    def __init__(self, chan_id: str, kv, role: str,
                 timeout_ms: int = 30_000, host: str = "127.0.0.1",
                 authkey: bytes = None):
        import socket as _socket

        assert role in ("reader", "writer")
        self._id = chan_id
        self._kv = kv          # kv(op, key, value=None) -> value
        self._role = role
        self._host = host      # reader's node host, set at COMPILE time
        if authkey is None:
            from ray_tpu_torch.core.cluster.rpc import cluster_authkey

            authkey = cluster_authkey()
        self._authkey = authkey
        self._conn = None
        self._await_ack = False
        self._got_any = False  # reader: saw >=1 message on this conn
        self._sock = None
        if role == "reader":
            s = _socket.socket()
            s.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
            try:
                # listen only on the advertised interface; "" would accept
                # from any interface on multi-homed hosts
                s.bind((host, 0))
            except OSError:
                s.bind(("", 0))
            s.listen(4)
            self._sock = s
            # publish only the PORT: the HOST comes from the descriptor,
            # where the compiler wrote the node's advertised address
            # (gethostname() resolves to loopback on stock images and
            # would point cross-node writers at themselves)
            self._kv("put", f"dagchan:{chan_id}", s.getsockname()[1])

    @classmethod
    def create_id(cls) -> str:
        import os as _os

        return _os.urandom(8).hex()

    def descriptor(self) -> Tuple[str, str, str]:
        return ("sock", self._id, self._host)

    def _ensure_conn(self, timeout_ms: int):
        import socket as _socket
        import threading
        import time as _time

        if self._conn is not None:
            return
        if self._role == "reader":
            # keep accepting until an AUTHENTICATED peer connects, so a
            # stray probe can neither hijack the edge nor wedge it.
            # Handshakes run on their own threads: a silent probe holding
            # its connection open must not serialize behind the accept
            # loop and starve the legitimate writer.
            import queue as _queue

            deadline = (None if timeout_ms < 0
                        else _time.monotonic() + max(0.001, timeout_ms / 1000))
            won: "_queue.Queue" = _queue.Queue()

            def _try_auth(c):
                try:
                    c.settimeout(5.0)
                    _mutual_auth(c, self._authkey, "reader")
                    if getattr(won, "closed", False):
                        c.close()  # a winner was already adopted
                    else:
                        won.put(c)
                except Exception:  # noqa: BLE001 — unauthenticated peer
                    try:
                        c.close()
                    except Exception:  # noqa: BLE001
                        pass

            conn = None
            while conn is None:
                try:
                    conn = won.get_nowait()
                    break
                except _queue.Empty:
                    pass
                if deadline is not None and _time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"socket channel {self._id}: no authenticated "
                        f"writer connected")
                self._sock.settimeout(0.25)
                try:
                    c, _ = self._sock.accept()
                except (TimeoutError, OSError):
                    continue
                threading.Thread(target=_try_auth, args=(c,),
                                 daemon=True).start()
            # close runner-ups: exactly one authenticated peer per edge
            won.closed = True
            while True:
                try:
                    won.get_nowait().close()
                except (_queue.Empty, OSError):
                    break
        else:
            # rendezvous (KV publish) is prompt — bounded even for -1
            kv_deadline = _time.monotonic() + (
                30.0 if timeout_ms < 0 else timeout_ms / 1000)
            port = None
            while _time.monotonic() < kv_deadline:
                port = self._kv("get", f"dagchan:{self._id}")
                if port:
                    break
                _time.sleep(0.01)
            if not port:
                raise TimeoutError(
                    f"socket channel {self._id}: reader never published")
            # retry transient handshake timeouts (reader busy vetting a
            # probe, or not accept()ing yet because its stage is blocked
            # downstream) until the caller's deadline; timeout_ms=-1 means
            # BLOCK — stage loops legitimately wait minutes on slow
            # downstreams. A wrong key fails fast.
            deadline = (None if timeout_ms < 0
                        else _time.monotonic() + timeout_ms / 1000)
            conn = None
            while True:
                c = None
                try:
                    c = _socket.create_connection(
                        (self._host, int(port)),
                        timeout=5.0 if deadline is None else
                        max(0.05, min(5.0, deadline - _time.monotonic())))
                    c.settimeout(5.0)
                    _mutual_auth(c, self._authkey, "writer")
                    conn = c
                    break
                except ConnectionRefusedError:
                    # the reader binds BEFORE publishing its port, so a
                    # refusal means it died — fail, don't spin (matters
                    # for timeout_ms=-1, which has no deadline)
                    raise ChannelClosed(
                        f"socket channel {self._id}: reader is gone")
                except PermissionError:
                    # wrong authkey (or EPERM from connect itself, in
                    # which case c is still None): fail fast, no retry
                    if c is not None:
                        c.close()
                    raise
                except Exception:  # noqa: BLE001 — timeout / peer reset
                    try:
                        c.close()
                    except Exception:  # noqa: BLE001
                        pass
                    if deadline is not None \
                            and _time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"socket channel {self._id}: handshake never "
                            f"completed")
                    _time.sleep(0.05)
        # drop the handshake timeout: sends must honor the caller's
        # timeout_ms semantics (-1 = block), not a 5s auth cap
        conn.settimeout(None if timeout_ms < 0 else timeout_ms / 1000)
        conn.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._conn = conn

    def _recv_exact(self, n: int, timeout_ms: int) -> bytes:
        self._conn.settimeout(None if timeout_ms < 0
                              else max(0.001, timeout_ms / 1000))
        buf = bytearray()
        while len(buf) < n:
            chunk = self._conn.recv(n - len(buf))
            if not chunk:
                raise ChannelClosed
            buf.extend(chunk)
        return bytes(buf)

    def write(self, value: Any, timeout_ms: int = 10_000):
        self.write_raw(_chan_dumps(value), timeout_ms)

    def write_raw(self, data: bytes, timeout_ms: int = 10_000):
        self._ensure_conn(timeout_ms)
        if self._await_ack:
            if self._recv_exact(1, timeout_ms) != b"A":
                raise ChannelClosed
            self._await_ack = False
        self._conn.sendall(struct.pack("<Q", len(data)) + data)
        self._await_ack = True

    def read(self, timeout_ms: int = 10_000) -> Any:
        import time as _time

        deadline = (None if timeout_ms < 0
                    else _time.monotonic() + timeout_ms / 1000)
        while True:
            self._ensure_conn(timeout_ms)
            try:
                (length,) = struct.unpack(
                    "<Q", self._recv_exact(8, timeout_ms))
                break
            except ChannelClosed:
                # EOF before the FIRST message: the adopted connection's
                # writer abandoned its handshake attempt (auth-timeout
                # race) and is retrying — fall back to accepting instead
                # of wedging the edge. EOF after traffic is a real close.
                if (self._role == "reader" and not self._got_any
                        and self._sock is not None
                        and (deadline is None
                             or _time.monotonic() < deadline)):
                    try:
                        self._conn.close()
                    except Exception:  # noqa: BLE001
                        pass
                    self._conn = None
                    continue
                raise
            except OSError as e:
                raise TimeoutError(f"socket channel read: {e}") from e
        if length == _CLOSE_LEN:
            raise ChannelClosed
        data = self._recv_exact(length, timeout_ms)
        value = pickle.loads(data)
        self._conn.sendall(b"A")
        self._got_any = True
        return value

    def close(self, timeout_ms: int = 5000):
        try:
            self._ensure_conn(timeout_ms)
            if self._await_ack:
                self._recv_exact(1, timeout_ms)
                self._await_ack = False
            self._conn.sendall(struct.pack("<Q", _CLOSE_LEN))
        except Exception:  # noqa: BLE001 — dead peer: nothing to close
            pass

    def release(self):
        for s in (self._conn, self._sock):
            if s is not None:
                try:
                    s.close()
                except Exception:  # noqa: BLE001
                    pass
        if self._role == "reader":
            try:
                self._kv("del", f"dagchan:{self._id}")
            except Exception:  # noqa: BLE001
                pass


def open_endpoint(desc, store=None, kv=None, role: str = "reader",
                  timeout_ms: int = 30_000, authkey: bytes = None):
    """Open any channel kind from its descriptor: shm and device
    channels need the store; a socket channel (a cross-node edge) takes
    the cluster KV for its rendezvous and its role."""
    if desc[0] == "sock":
        host = desc[2] if len(desc) > 2 else "127.0.0.1"
        return SocketChannel(desc[1], kv, role, timeout_ms, host=host,
                             authkey=authkey)
    if store is None:
        raise RuntimeError("shm channel endpoint needs a store")
    if desc[0] == "dev":
        return DeviceChannel.open(store, desc)
    return Channel.open(store, desc)
