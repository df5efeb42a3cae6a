"""The port's runtime: a copy of ``ray_tpu/core`` (tasks, actors,
objects, placement groups, the shm object store, the config table and
the fault-injection sites) with GPUs in place of TPU chips
(``resources.GpuSet``; ``num_gpus`` on actors), and ``cluster/``, the
multi-node substrate (GCS, node servers, TCP RPC, the ``Cluster``
fixture) whose nodes each embed that runtime."""
