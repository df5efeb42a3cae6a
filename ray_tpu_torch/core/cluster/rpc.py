"""The two transport pieces the single-node runtime uses.

``RpcError`` is the base of the cluster-plane exceptions in
``ray_tpu_torch.exceptions``, and ``_timed_handshake`` bounds the HMAC
challenge that the runtime's accept loop runs on every worker
connection. The threaded RPC server, the pooled client and the wire
contract come with cluster mode (ROADMAP.md section 1, item 1).
"""

from __future__ import annotations

import os
import socket
import threading
from multiprocessing.connection import answer_challenge, deliver_challenge
from typing import Optional

from ray_tpu_torch.core.config import config


class RpcError(Exception):
    """Transport-level RPC failure (peer died, connection refused).

    ``maybe_applied`` is True when the request made it onto the wire but
    the reply was lost, the op is not on the retry-after-apply whitelist,
    and the server may therefore have applied it once already — blind
    replay would risk running the side effect twice. False means the
    request either never reached the server or is safe to re-send.
    """

    maybe_applied: bool = False


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
    tests can shrink it through the env.
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
