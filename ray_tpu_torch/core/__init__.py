"""The port's single-node runtime: a copy of ``ray_tpu/core`` (tasks,
actors, objects, placement groups, the shm object store, the config
table and the fault-injection sites) with GPUs in place of TPU chips
(``resources.GpuSet``; ``num_gpus`` on actors). ``cluster/`` holds only
the RPC transport the runtime uses; cluster mode is a later slice."""
