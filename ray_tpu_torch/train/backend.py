"""Backend hooks: per-framework gang wiring.

Reference: python/ray/train/backend.py (Backend/BackendConfig) and
train/torch/config.py:154 (_TorchBackend wires torch.distributed). The
port's copy of ``ray_tpu/train/backend.py``, with ``TorchConfig`` /
``_TorchBackend`` in place of ``JaxConfig`` / ``_JaxBackend``: each worker
takes the card it holds as its current device, the gang can join one
``torch.distributed`` default group (NCCL on the card, gloo on the CPU),
and a host-level collective group named ``"train"`` carries reductions
outside the device (``parallel/collective.py``'s ``host`` backend).

The default group meets in a ``torch.distributed.TCPStore`` that rank 0
serves on its node's advertised address (the address the node's RPC
server binds: no host name is resolved, which gVisor may not do), as
``ray_tpu/train/backend.py`` meets ``jax.distributed`` at a coordinator
on rank 0's host. Rank 0 binds ``coordinator_port``, or a free port
when it is 0, so a gang may ``SPREAD`` across nodes. Each generation of
the gang (each elastic resize is one) meets in a fresh store.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclass
class BackendConfig:
    def backend_cls(self):
        return Backend

    def validate(self, scaling: ScalingConfig) -> None:
        """Refuse a configuration before any worker starts."""


class Backend:
    """No-op base backend."""

    def on_start(self, worker_group: WorkerGroup, backend_config: "BackendConfig"):
        pass

    def on_training_start(self, worker_group: WorkerGroup,
                          backend_config: "BackendConfig"):
        pass

    def abort_collectives(self, worker_group: WorkerGroup, reason: str):
        """Elastic resize, step 1: unblock survivors stuck in in-flight
        collectives (they fail over to CollectiveAbortedError within a
        poll interval instead of stalling out the op timeout). Called
        with the gang still at its OLD generation."""

    def unwind_timeout_s(self, backend_config: "BackendConfig") -> float:
        """How long a survivor may take to unwind from a collective that
        ``abort_collectives`` cannot reach (0: none such)."""
        return 0.0

    def on_resize(self, worker_group: WorkerGroup,
                  backend_config: "BackendConfig"):
        """Elastic resize, step 2: re-wire the (already re-ranked) gang
        at its new world size and generation — re-join collective
        groups, refresh device/distributed state on every worker
        (including workers added by a grow)."""

    def on_shutdown(self, worker_group: WorkerGroup,
                    backend_config: "BackendConfig"):
        pass


@dataclass
class TorchConfig(BackendConfig):
    """torch gang wiring.

    device: None means the card each worker holds (``ScalingConfig(
        use_gpu=True)``; the backend makes it the worker's current
        device, ``cuda:0`` in the worker whatever its rank); ``"cpu"``
        trains on the host. ``None`` without ``use_gpu`` raises at
        ``fit()``, before any worker starts: a gang never trains on the
        CPU unasked.
    distributed: join every worker to one ``torch.distributed`` default
        group (NCCL on the card, gloo on the CPU), at world size 1 too.
        A reused worker leaves the group it holds and joins the new one.
    coordinator_port: the port rank 0 serves the default group's
        ``TCPStore`` on; 0 picks a free one, so repeated gangs never
        collide.
    host_collectives: join the host-level collective group ``"train"``
        (the ``host`` backend of ``parallel/collective.py``).
    timeout_s: bound on the default group's rendezvous and each of its
        collectives. After an elastic resize, a survivor blocked in a
        collective with a dead peer unwinds within it: gloo fails such a
        collective at once, NCCL waits the timeout out.
    """

    device: Optional[str] = None
    distributed: bool = False
    coordinator_port: int = 0  # 0 = pick a free port on rank 0's node
    host_collectives: bool = True
    timeout_s: float = 1800.0

    def backend_cls(self):
        return _TorchBackend

    def validate(self, scaling: ScalingConfig) -> None:
        if self.device is None and not scaling.use_gpu:
            raise ValueError(
                "TorchConfig(device=None) trains on the card each worker "
                "holds, and ScalingConfig(use_gpu=False) gives the workers "
                "none: pass use_gpu=True, or device='cpu' to train on the "
                "host")


def _setup_device(device: Optional[str]) -> str:
    """Worker-side: make the card this worker holds (``device`` None) or
    names its current device. Returns the device as a string."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchConfig(device=None): this worker sees no CUDA card "
                f"(CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return str(dev)


# rank 0's TCPStore server for the generation it coordinates: it must
# outlive the join, and a later generation's replaces it
_COORDINATOR: dict = {}


def _pick_coordinator(host: str, port: int, world_size: int,
                      timeout_s: float) -> int:
    """Runs on rank 0: serve the default group's ``TCPStore`` on
    ``host`` (its node's advertised address) at ``port``, or at a free
    one when ``port`` is 0. Returns the port bound."""
    from datetime import timedelta

    import torch.distributed as dist

    _COORDINATOR.clear()
    store = dist.TCPStore(host, port, world_size, is_master=True,
                          timeout=timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    _COORDINATOR["store"] = store
    return store.port


def _join_process_group(host: str, port: int, world_size: int, rank: int,
                        device: Optional[str], timeout_s: float) -> None:
    """Worker-side: join (or re-join) the default process group, meeting
    in rank 0's ``TCPStore`` at ``host:port``."""
    from datetime import timedelta

    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import init_process_group

    if dist.is_initialized():
        # a reused worker: an earlier gang's group, or the previous
        # generation of this one
        dist.destroy_process_group()
    timeout = timedelta(seconds=timeout_s)
    if rank == 0:
        store = _COORDINATOR["store"]
    else:
        # a worker that was rank 0 of an earlier generation drops its
        # server: that generation's group is gone
        _COORDINATOR.clear()
        store = dist.TCPStore(host, port, world_size, is_master=False,
                              timeout=timeout)
    init_process_group(rank, world_size, device, store=store,
                       timeout=timeout)


def _leave_process_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _COORDINATOR.clear()


def _join_host_collective_group(world_size: int, rank: int, group_name: str,
                                generation: int = 0):
    from ray_tpu_torch.parallel import collective

    collective.init_collective_group(world_size, rank, backend="host",
                                     group_name=group_name,
                                     generation=generation)


TRAIN_GROUP = "train"


def _rank0_host(worker_group: WorkerGroup) -> str:
    """The address rank 0's node advertises: its RPC server's host on a
    cluster driver, loopback in the single-node runtime."""
    from ray_tpu_torch.core import runtime_context

    core = runtime_context.get_core()
    addr_of = getattr(core, "_actor_addr", None)
    if addr_of is None:
        return "127.0.0.1"
    return addr_of(worker_group.workers[0]._actor_id)[0]


class _TorchBackend(Backend):
    def _setup_workers(self, worker_group: WorkerGroup, cfg: TorchConfig):
        """Device and default group on every worker."""
        import ray_tpu_torch

        device = None if cfg.device is None else str(cfg.device)
        if device != "cpu":
            # the card each worker holds (or the one named)
            worker_group.execute(_setup_device, device)
        if cfg.distributed:
            n = len(worker_group)
            host = _rank0_host(worker_group)
            port = worker_group.execute_single(
                0, _pick_coordinator, host, cfg.coordinator_port, n,
                cfg.timeout_s)
            ray_tpu_torch.get([
                w.execute.remote(_join_process_group, host, port, n, rank,
                                 device, cfg.timeout_s)
                for rank, w in enumerate(worker_group.workers)])

    def on_start(self, worker_group: WorkerGroup, cfg: TorchConfig):
        from ray_tpu_torch.train.session import _install_preemption_handler

        self._setup_workers(worker_group, cfg)
        # maintenance events arrive as SIGTERM: give every gang worker a
        # grace window to checkpoint (session.preempted())
        worker_group.execute(_install_preemption_handler)

    def _join_collectives(self, worker_group: WorkerGroup, cfg: TorchConfig):
        if cfg.host_collectives and len(worker_group) > 1:
            import ray_tpu_torch

            refs = [
                w.execute.remote(_join_host_collective_group,
                                 len(worker_group), rank, TRAIN_GROUP,
                                 worker_group.generation)
                for rank, w in enumerate(worker_group.workers)
            ]
            ray_tpu_torch.get(refs)

    def on_training_start(self, worker_group: WorkerGroup, cfg: TorchConfig):
        self._join_collectives(worker_group, cfg)

    def abort_collectives(self, worker_group: WorkerGroup, reason: str):
        from ray_tpu_torch.parallel import collective

        collective.abort_group(TRAIN_GROUP, reason,
                               generation=worker_group.generation)

    def unwind_timeout_s(self, cfg: TorchConfig) -> float:
        return cfg.timeout_s if cfg.distributed else 0.0

    def on_resize(self, worker_group: WorkerGroup, cfg: TorchConfig):
        from ray_tpu_torch.parallel import collective

        # the previous incarnation's (aborted) coordinator has been fully
        # drained by now; reclaim its name slot
        if worker_group.generation > 0:
            collective.destroy_coordinator(
                TRAIN_GROUP, generation=worker_group.generation - 1)
        # idempotent for survivors, required for grown-in workers; each
        # survivor leaves the old default group and joins one at the new
        # world size. The preemption flags stay as they are: a survivor
        # whose SIGTERM landed after its last step boundary has not acted
        # on it yet, and a grown-in worker's starts clear (the reference
        # clears them here, and so loses that survivor's preemption)
        self._setup_workers(worker_group, cfg)
        self._join_collectives(worker_group, cfg)

    def on_shutdown(self, worker_group: WorkerGroup, cfg: TorchConfig):
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import RayTpuError
        from ray_tpu_torch.parallel import collective

        if cfg.distributed and len(worker_group):
            # best effort: a worker that died or is wedged in a collective
            # is killed right after by the worker group's shutdown
            try:
                ray_tpu_torch.get(worker_group.execute_async(
                    _leave_process_group), timeout=10.0)
            except (RayTpuError, RuntimeError):
                pass
        # reclaim the current incarnation's coordinator so a later gang
        # (cold restart in the same runtime) starts from fresh,
        # un-aborted state
        collective.destroy_coordinator(
            TRAIN_GROUP, generation=worker_group.generation)
