"""A cluster driver's heartbeat, sent from a process of its own.

``python -m ray_tpu_torch.core.cluster.driver_beat HOST PORT DRIVER_ID``
(the driver id in hex, the cluster's authkey in ``RTPU_CLUSTER_AUTHKEY``)
sends ``driver_heartbeat`` to the GCS every
``driver_heartbeat_interval_s`` until its standard input closes. The
driver holds the pipe's other end, so the beats stop when the driver
process ends, and the GCS declares it dead ``driver_heartbeat_timeout_s``
later, as before. What no longer stops them is a driver that holds its
GIL: its own heartbeat thread (``ClusterCore._death_watch``) cannot run
then, and a driver that spent longer than the timeout in one C call was
declared dead and lost its actors. Re-registration after a GCS restart
stays with the driver's thread: a ``False`` reply is ignored here.
"""

from __future__ import annotations

import os
import select
import sys


def main() -> None:
    from ray_tpu_torch.core import netem
    from ray_tpu_torch.core.cluster.rpc import RpcClient, cluster_authkey
    from ray_tpu_torch.core.config import config

    host, port, driver_id = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    netem.set_identity("driver")
    period = config.driver_heartbeat_interval_s
    client = RpcClient((host, port), cluster_authkey(),
                       connect_timeout=period)
    msg = ("driver_heartbeat", bytes.fromhex(driver_id))
    try:
        while True:
            try:
                client.call(msg)
            # rtpu-lint: disable=L4 — a missed beat (GCS down or
            # restarting, a remote error) is retried at the next tick
            except Exception:  # noqa: BLE001
                pass
            ready, _, _ = select.select([sys.stdin], [], [], period)
            if ready and not os.read(sys.stdin.fileno(), 1):
                return  # the driver closed the pipe, or died
    finally:
        client.close()


if __name__ == "__main__":
    main()
