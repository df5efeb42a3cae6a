"""TCP RPC substrate for the cluster plane.

``multiprocessing.connection`` over AF_INET gives framed pickling plus an
HMAC authkey handshake; on top of that this module provides a threaded
request/response server and a pooled client. This fills the role gRPC plays
in the reference (src/ray/rpc/grpc_server.h) at single-digit-node scale;
the wire format is an implementation detail hidden behind RpcClient/serve.

Blocking RPCs (e.g. a get that waits for a task) hold one pooled connection
for their duration; the pool grows on demand and idles out.

Retry semantics are NOT decided here: ``WIRE_CONTRACT`` in
``protocol_meta.py`` is the single source of truth classifying every wire
op as idempotent / retry-after-apply / dedup-keyed / non-retryable, and
``_retry_safe_after_apply`` below merely consults the sets derived from it.
"""

from __future__ import annotations

import os
import random
import socket
import threading
import time
from multiprocessing.connection import Client as _MpClient  # noqa: F401
from multiprocessing.connection import Connection as _MpConnection
from multiprocessing.connection import answer_challenge, deliver_challenge
from typing import Any, Callable, List, Optional, Tuple

from ray_tpu_torch.core import netem
from ray_tpu_torch.core.cluster import protocol_meta
from ray_tpu_torch.core.config import config
from ray_tpu_torch.util.debug_lock import make_lock


class RpcError(Exception):
    """Transport-level RPC failure (peer died, connection refused).

    ``maybe_applied`` is True when the request made it onto the wire but
    the reply was lost, the op is not on the retry-after-apply whitelist,
    and the server may therefore have applied it once already — blind
    replay would risk running the side effect twice. False means the
    request either never reached the server or is safe to re-send.
    """

    maybe_applied: bool = False


class RemoteError(Exception):
    """Application-level error raised by the remote handler."""


def _timed_handshake(conn, authkey: bytes, *, server_side: bool,
                     timeout: Optional[float] = None):
    """Run the HMAC challenge with a hard deadline.

    ``multiprocessing``'s challenge reads have NO timeout; worse, its
    Listener runs the handshake inside ``accept()``, so one half-open
    connection (a peer that connected and then stalled or died silently)
    wedges the single accept loop and every subsequent connection to the
    server hangs in ``answer_challenge`` forever — observed as node
    fetch threads stuck mid-connect while pooled connections kept
    working. A watchdog closes the connection at the deadline, which
    unblocks the in-flight read with EOF/OSError.

    The default deadline is the ``rpc_handshake_timeout_s`` flag, so
    partition tests can shrink it cluster-wide through the env.
    """
    if timeout is None:
        timeout = config.rpc_handshake_timeout_s
    done = threading.Event()

    def watchdog():
        if not done.wait(timeout):
            # closing the fd does NOT unblock a read already parked in
            # another thread on Linux; shutdown() on the shared file
            # description does (the read returns EOF)
            try:
                s = socket.socket(fileno=os.dup(conn.fileno()))
                try:
                    s.shutdown(socket.SHUT_RDWR)
                finally:
                    s.close()
            except (OSError, ValueError):
                # handshake already finished and closed the conn under us
                # (fileno on a closed Connection) — nothing left to unblock
                pass
            try:
                conn.close()
            except OSError:
                pass

    threading.Thread(target=watchdog, daemon=True,
                     name="rpc-handshake-wd").start()
    try:
        if server_side:
            deliver_challenge(conn, authkey)
            answer_challenge(conn, authkey)
        else:
            answer_challenge(conn, authkey)
            deliver_challenge(conn, authkey)
    finally:
        done.set()


def pick_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _ReuseAddrListener:
    """``multiprocessing.connection.Listener`` equivalent (same framed
    ``Connection`` objects) over a SO_REUSEADDR socket: a server
    restarted on the SAME port — the GCS failover path — must not lose
    the bind to a predecessor connection lingering in TIME_WAIT."""

    def __init__(self, address: Tuple[str, int]):
        self._sock = socket.create_server(address, backlog=128)
        self.address = self._sock.getsockname()

    def accept(self):
        s, _ = self._sock.accept()
        s.setblocking(True)
        return _MpConnection(s.detach())

    def close(self):
        # shutdown() first: close() alone does not release the socket
        # while the accept thread is parked in accept() (the in-flight
        # syscall pins the open file description, which would keep the
        # port bound and fail a same-port successor)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class RpcServer:
    """Threaded request/response server.

    handler(msg, ctx) -> reply. Exceptions in the handler are shipped back
    and re-raised client-side as RemoteError (or the original exception when
    picklable). ``ctx`` is a per-connection dict handlers may use to stash
    state (e.g. peer identity after a hello message).
    """

    def __init__(self, handler: Callable[[Any, dict], Any],
                 authkey: bytes, host: str = "127.0.0.1", port: int = 0):
        self._handler = handler
        self._authkey = authkey
        if port == 0:
            port = pick_port()
        # NO authkey on the listener: accept() must return immediately
        # after the TCP accept; the HMAC handshake runs (bounded) in the
        # per-connection thread — see _timed_handshake
        self._listener = _ReuseAddrListener((host, port))
        self.address: Tuple[str, int] = (host, port)
        self._stop = False
        # live accepted connections, severed on close(): the per-conn
        # threads are parked in recv() and would otherwise keep serving
        # a "closed" server until the process exits
        self._conns: set = set()
        self._conns_lock = make_lock("RpcServer._conns_lock")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="rpc-accept")
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError, Exception):  # noqa: BLE001
                if self._stop:
                    return
                continue
            # daemon threads, never joined — don't retain references
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="rpc-conn").start()

    def _serve_conn(self, conn):
        ctx: dict = {}
        with self._conns_lock:
            if self._stop:
                try:
                    conn.close()
                except OSError:
                    pass
                return
            self._conns.add(conn)
        try:
            self._serve_conn_inner(conn, ctx)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def _serve_conn_inner(self, conn, ctx):
        try:
            _timed_handshake(conn, self._authkey, server_side=True)
        # rtpu-lint: disable=L4 — any handshake failure (bad key, stall,
        # peer death, watchdog-forced EOF) means the same thing: drop the
        # connection; the server must survive arbitrary garbage from peers
        except Exception:  # noqa: BLE001 — bad key / stalled / died
            try:
                conn.close()
            except OSError:
                pass
            return
        try:
            while not self._stop:
                msg = conn.recv()
                if netem.enabled():
                    # at=server rules: inbound delay sleeps here; an
                    # inbound fault raises NetemFault (an OSError),
                    # severing this connection mid-exchange — the peer
                    # observes a sent-but-unanswered request
                    netem.plan_dispatch()
                try:
                    reply = ("ok", self._handler(msg, ctx))
                except BaseException as e:  # noqa: BLE001
                    reply = ("exc", e)
                try:
                    conn.send(reply)
                except (EOFError, OSError):
                    raise
                except Exception:  # noqa: BLE001 — unpicklable payload/exc:
                    # degrade to a picklable error instead of killing the
                    # connection (which clients would misread as node death)
                    conn.send(("exc", RemoteError(
                        f"unpicklable {'error' if reply[0] == 'exc' else 'reply'}: "
                        f"{reply[1]!r}")))
        except (EOFError, OSError):
            pass
        finally:
            on_close = ctx.get("on_close")
            if on_close is not None:
                try:
                    on_close()
                # rtpu-lint: disable=L4 — on_close is an arbitrary
                # handler-registered callback; a buggy one must not take
                # down the connection teardown path with it
                except Exception:  # noqa: BLE001
                    pass
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        self._stop = True
        try:
            self._listener.close()
        except OSError:
            pass
        # sever live connections: their serve threads are parked in
        # recv() and would otherwise keep answering pooled clients after
        # "close" (a process kill severs them; in-process close must too)
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                s = socket.socket(fileno=conn.fileno())
                try:
                    s.shutdown(socket.SHUT_RDWR)
                finally:
                    s.detach()
            except OSError:
                pass


# Ops that are safe to retry after the request may have been APPLIED once
# (reply lost: send succeeded, recv failed): every op WIRE_CONTRACT in
# protocol_meta.py classifies as a read, a set-style write where
# apply-twice == apply-once, or dedup-keyed exactly-once. That table is
# the single source of truth — classify new ops THERE, never here; the
# L9 lint rule rejects retry paths that disagree with it.
# The reference splits the same way: gRPC retries are enabled per-method
# only for idempotent GCS reads (src/ray/rpc/gcs_server/gcs_rpc_client.h).
_IDEMPOTENT_OPS = protocol_meta.RETRY_SAFE_OPS

_IDEMPOTENT_KV_SUBOPS = protocol_meta.RETRY_SAFE_KV_SUBOPS


def _retry_safe_after_apply(msg) -> bool:
    """True when re-sending ``msg`` is safe even if the server already
    applied it once (at-least-once delivery is indistinguishable from
    exactly-once for these ops)."""
    try:
        op = msg[0]
    except Exception:  # noqa: BLE001
        return False
    if op == "kv":
        return len(msg) > 1 and msg[1] in _IDEMPOTENT_KV_SUBOPS
    return op in _IDEMPOTENT_OPS


class RpcClient:
    """Pooled client to one RpcServer address.

    Thread-safe: each call checks out a connection (creating one if the pool
    is dry), does one request/response round trip, and returns it.
    """

    def __init__(self, address: Tuple[str, int], authkey: bytes,
                 connect_timeout: float = 10.0,
                 unavailable_exc: Optional[type] = None):
        self.address = tuple(address)
        self._authkey = authkey
        self._timeout = connect_timeout
        # Exception type raised when connect retries exhaust (must accept
        # a single message argument). Lets GCS clients surface a typed
        # GcsUnavailableError while plain node clients keep RpcError.
        self._unavailable_exc = unavailable_exc or RpcError
        self._pool: List[Any] = []
        self._lock = make_lock("RpcClient._lock")
        self._closed = False
        # bumped whenever an established connection failed and we dialed
        # again: lets wrappers (HaGcsClient) notice a server restart that
        # the in-call reconnect absorbed without surfacing any error
        self.reconnects = 0

    def _connect(self):
        deadline = time.monotonic() + self._timeout
        delay = 0.02
        while True:
            try:
                # connect WITHOUT authkey, then run the bounded
                # handshake ourselves — a wedged/half-dead server must
                # not hang this thread forever (see _timed_handshake)
                conn = _MpClient(self.address)
                try:
                    _timed_handshake(conn, self._authkey,
                                     server_side=False)
                except Exception as he:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    from multiprocessing import AuthenticationError
                    if isinstance(he, AuthenticationError):
                        # deterministic: retrying a wrong key only
                        # hammers the server until the deadline
                        raise RpcError(
                            f"authentication rejected by "
                            f"{self.address}: {he}") from he
                    raise OSError(
                        f"authkey handshake with {self.address[0]}:"
                        f"{self.address[1]} failed/timed out "
                        f"(rpc_handshake_timeout_s="
                        f"{config.rpc_handshake_timeout_s:g})")
                return conn
            except (ConnectionRefusedError, OSError) as e:
                if self._closed:
                    # closed while dialing (the driver saw the node die):
                    # the call fails now, not at the connect deadline
                    raise RpcError(
                        f"client to {self.address} closed while "
                        f"connecting: {e}") from e
                if time.monotonic() >= deadline:
                    raise self._unavailable_exc(
                        f"cannot connect to {self.address}: {e}") from e
                # Exponential backoff with full jitter: a restarting
                # server sees the whole cluster reconnect at once, and
                # synchronized retries stampede its accept loop.
                time.sleep(min(delay * random.random() + 0.005,
                               max(deadline - time.monotonic(), 0.005)))
                delay = min(delay * 2, 0.5)

    def call(self, msg: Any) -> Any:
        with self._lock:
            if self._closed:
                raise RpcError("client closed")
            conn = self._pool.pop() if self._pool else None
        if conn is None:
            conn = self._connect()
        sent = False
        try:
            # Netem weave: a fault rule (drop/partition/blackhole)
            # raises NetemFault — an OSError — BEFORE any bytes move,
            # landing in the sent=False safe-retry arm below exactly
            # like a refused connect; "dup" double-sends the request on
            # this pipelined connection (the server applies it twice,
            # back-to-back); "lost_reply" raises AFTER the send so the
            # sent=True / maybe_applied machinery is exercised for real.
            plan = netem.plan_send(self.address, msg) \
                if netem.enabled() else None
            conn.send(msg)
            if plan == "dup":
                conn.send(msg)
            sent = True
            if plan == "lost_reply":
                raise netem.NetemFault(
                    f"netem lost_reply: reply from {self.address[0]}:"
                    f"{self.address[1]} discarded")
            tag, value = conn.recv()
            if plan == "dup":
                conn.recv()  # drain the duplicate's reply
        except (EOFError, OSError, BrokenPipeError) as e:
            try:
                conn.close()
            except OSError:
                pass
            # same-address retry: a pooled connection that fails almost
            # certainly died while parked (server restart) — drop the
            # whole pool (parked siblings share its fate); a fresh
            # connection that fails mid-exchange gets one more try too,
            # so a lost REPLY is retried on the SAME server, where nonce
            # dedup (node_server._dedup) makes re-delivery exactly-once.
            # Retry is only safe when the request cannot have been
            # applied (send itself failed — partial frames are discarded
            # server-side) OR the op is retry-safe per the whitelist; a
            # lost reply to anything else surfaces as RpcError, never
            # re-runs side effects (at-least-once hazard).
            if not sent or _retry_safe_after_apply(msg):
                with self._lock:
                    stale, self._pool = self._pool, []
                    self.reconnects += 1
                for c in stale:
                    try:
                        c.close()
                    except OSError:
                        pass
                conn = self._connect()
                sent2 = False
                try:
                    # the retry passes through netem too: a partition
                    # blocks the built-in same-address retry as well,
                    # so the caller sees a fast typed failure instead
                    # of an accidental escape hatch around the chaos
                    plan2 = netem.plan_send(self.address, msg) \
                        if netem.enabled() else None
                    conn.send(msg)
                    if plan2 == "dup":
                        conn.send(msg)
                    sent2 = True
                    if plan2 == "lost_reply":
                        raise netem.NetemFault(
                            f"netem lost_reply: reply from "
                            f"{self.address[0]}:{self.address[1]} "
                            f"discarded")
                    tag, value = conn.recv()
                    if plan2 == "dup":
                        conn.recv()  # drain the duplicate's reply
                except (EOFError, OSError, BrokenPipeError) as e2:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    err2 = RpcError(
                        f"rpc to {self.address} failed: {e2}")
                    err2.maybe_applied = (
                        sent2 and not _retry_safe_after_apply(msg))
                    raise err2 from e2
            else:
                err = RpcError(f"rpc to {self.address} failed: {e}")
                err.maybe_applied = True  # sent and not retry-safe
                raise err from e
        with self._lock:
            if self._closed:
                conn.close()
            else:
                self._pool.append(conn)
        if tag == "exc":
            raise value
        return value

    def try_call(self, msg: Any, default=None):
        """call() that swallows transport errors (for best-effort releases)."""
        try:
            return self.call(msg)
        except RpcError:
            return default

    def close(self):
        with self._lock:
            self._closed = True
            pool, self._pool = self._pool, []
        for conn in pool:
            try:
                conn.close()
            except OSError:
                pass


class ClientCache:
    """Process-wide cache of RpcClients keyed by address."""

    def __init__(self, authkey: bytes):
        self._authkey = authkey
        self._clients = {}
        self._lock = make_lock("ClientCache._lock")

    def get(self, address: Tuple[str, int]) -> RpcClient:
        address = tuple(address)
        with self._lock:
            c = self._clients.get(address)
            if c is None:
                c = self._clients[address] = RpcClient(address, self._authkey)
            return c

    def drop(self, address: Tuple[str, int]):
        with self._lock:
            c = self._clients.pop(tuple(address), None)
        if c is not None:
            c.close()

    def close_all(self):
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()


def cluster_authkey() -> bytes:
    """The cluster session authkey (hex in RTPU_CLUSTER_AUTHKEY).

    There is deliberately no default: the transport deserializes pickles,
    so a well-known key would hand any local user code execution in the
    cluster processes. Every launcher (Cluster fixture, CLI) generates a
    random key and passes it via the environment."""
    key = os.environ.get("RTPU_CLUSTER_AUTHKEY")
    if key:
        return bytes.fromhex(key)
    raise RuntimeError(
        "RTPU_CLUSTER_AUTHKEY is not set. Generate one (e.g. "
        "`python -c \"import os; print(os.urandom(16).hex())\"`) and export "
        "it identically in every cluster process.")
