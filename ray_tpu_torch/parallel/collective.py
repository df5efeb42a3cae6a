"""Host-level collective groups across actors (the out-of-band API).

The port's copy of ``ray_tpu/parallel/collective.py``, which mirrors the
reference's ``ray.util.collective`` surface (collective.py:120
init_collective_group, :258 allreduce, :373 broadcast, :423 allgather,
:531/:594 send/recv), on the port's runtime, with two backends:

- ``backend="host"``: cross-process collectives through a named coordinator
  actor + the shared-memory object store (as the reference). The
  coordinator plays the role of the reference's ``Rendezvous`` actor
  (collective_group/nccl_collective_group.py:29) and carries the data
  itself.
- ``backend="torch"``: the collectives of ``torch.distributed`` over this
  process's default group (NCCL on the card, gloo on the CPU; a gang gets
  one from ``TorchConfig(distributed=True)``). It takes the place of the
  reference's ``"xla"`` backend, which psums over the local devices of
  one process with ``shard_map``; ``backend="xla"`` raises a ValueError
  that names ``"torch"``.

Tensors in, tensors out: numpy in gives numpy out, as in the reference;
a torch tensor in (CPU or CUDA, any dtype, bf16 included) comes back as
a tensor of its dtype on the caller's device. On the host backend a
tensor travels to the coordinator as a CPU tensor (out of band, through
the store when large) and never through numpy, which has no bf16; the
coordinator reduces tensors with torch on the CPU. ``recv`` returns what
was sent, a tensor arriving on the CPU. This module imports torch only
when a tensor reaches it.

Gang-step data-plane collectives in trainers do NOT go through the host
backend; they run on the device over the process group
(parallel/device_collectives.py, or ``backend="torch"``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.exceptions import RayTpuError

_COORD_PREFIX = "rtpt_collective::"
_groups: Dict[str, "CollectiveGroup"] = {}

REDUCE_OPS = ("sum", "prod", "min", "max")
BACKENDS = ("host", "torch")

# Sentinel the coordinator hands back from every rendezvous method once
# the group is aborted; members convert it into CollectiveAbortedError.
# A marker return (instead of raising inside the actor) keeps the abort
# indistinguishable from a normal reply on the wire — no reliance on
# exception pickling — and lets blocked pollers observe it on their very
# next 2 ms poll instead of waiting out the 120 s _sync_op timeout.
_ABORT = "__rtpt_collective_abort__"


class CollectiveAbortedError(RayTpuError):
    """An in-flight collective was aborted — typically because a gang
    peer died and the driver is resizing the group. The message names
    the reason (including the dead rank when known). Callers inside a
    train loop should let it propagate: the session/executor treat it
    as a resize signal, not an application error."""


def _is_tensor(x) -> bool:
    from ray_tpu_torch.core.serialization import loaded_torch

    torch = loaded_torch()
    return torch is not None and isinstance(x, torch.Tensor)


def _wire(x):
    """What a member sends: a tensor as a contiguous CPU tensor of its
    dtype, anything else as a numpy array."""
    if _is_tensor(x):
        return x.detach().to("cpu").contiguous()
    return np.asarray(x)


def _back(x, like):
    """A result in the caller's terms: on a tensor's device when the
    caller passed a tensor."""
    if _is_tensor(like) and _is_tensor(x):
        return x.to(like.device)
    return x


def _reduce2(a, b, op: str):
    if _is_tensor(a):
        import torch

        if op == "sum":
            return a + b
        if op == "prod":
            return a * b
        return torch.minimum(a, b) if op == "min" else torch.maximum(a, b)
    if op == "sum":
        return a + b
    if op == "prod":
        return a * b
    if op == "min":
        return np.minimum(a, b)
    return np.maximum(a, b)


class _Coordinator:
    """Named actor holding rendezvous + reduction state for one group.

    Methods are polled by members; per-operation state is keyed by a
    monotonically increasing per-member round counter so reuse is safe.
    Once ``abort`` is called every rendezvous method returns the abort
    marker forever — the group is dead and must be re-created (under a
    new generation) to be used again.
    """

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.rounds: Dict[str, dict] = {}
        self.mailbox: Dict[Tuple[int, int, int], Any] = {}
        self.aborted: Optional[str] = None

    def abort(self, reason: str):
        self.aborted = reason or "collective group aborted"
        self.rounds.clear()
        self.mailbox.clear()
        return True

    def contribute(self, key: str, rank: int, data, op: str):
        if self.aborted is not None:
            return (_ABORT, self.aborted)
        st = self.rounds.setdefault(key, {"parts": {}, "result": None, "op": op})
        st["parts"][rank] = data
        if len(st["parts"]) == self.world_size and st["result"] is None:
            parts = [st["parts"][r] for r in range(self.world_size)]
            st["result"] = self._combine(parts, op)
        return st["result"] is not None

    def fetch(self, key: str, rank: int):
        if self.aborted is not None:
            return (_ABORT, self.aborted)
        st = self.rounds.get(key)
        if st is None or st["result"] is None:
            return False, None
        st.setdefault("fetched", set()).add(rank)
        result = st["result"]
        if len(st["fetched"]) == self.world_size:
            del self.rounds[key]  # all members have it; free the round
        return True, result

    @staticmethod
    def _combine(parts: List[Any], op: str):
        if op == "gather":
            return parts
        if op == "barrier":
            return True
        if op.startswith("bcast:"):
            src = int(op.split(":", 1)[1])
            return parts[src]
        if op not in REDUCE_OPS:
            raise ValueError(f"unknown reduce op {op!r}")
        if _is_tensor(parts[0]):
            # in rank order, as the numpy path below
            out = parts[0].clone()
            for p in parts[1:]:
                out = _reduce2(out, p, op)
            return out
        arrs = [np.asarray(p) for p in parts]
        if op == "sum":
            out = arrs[0].copy()
            for a in arrs[1:]:
                out += a
            return out
        if op == "prod":
            out = arrs[0].copy()
            for a in arrs[1:]:
                out *= a
            return out
        if op == "min":
            return np.minimum.reduce(arrs)
        return np.maximum.reduce(arrs)

    def post(self, src: int, dst: int, tag: int, data):
        if self.aborted is not None:
            return (_ABORT, self.aborted)
        self.mailbox[(src, dst, tag)] = data
        return None

    def take(self, src: int, dst: int, tag: int):
        if self.aborted is not None:
            return (_ABORT, self.aborted)
        if (src, dst, tag) in self.mailbox:
            return True, self.mailbox.pop((src, dst, tag))
        return False, None


class CollectiveGroup:
    """A member's view of one collective group."""

    def __init__(self, group_name: str, world_size: int, rank: int,
                 backend: str = "host", generation: int = 0):
        if backend == "xla":
            raise ValueError(
                "backend='xla' is the reference's in-process JAX group; "
                "the port's counterpart is backend='torch' "
                "(torch.distributed over the default process group)")
        if backend not in BACKENDS:
            raise ValueError(
                f"backend must be 'host' or 'torch', got {backend!r}")
        self.name = group_name
        self.world_size = world_size
        self.rank = rank
        self.backend = backend
        self.generation = generation
        self._round = 0
        self._coord = None
        if backend == "host":
            self._coord = _get_or_create_coordinator(
                group_name, world_size, generation)
        else:
            import torch.distributed as dist

            if not dist.is_initialized():
                raise RuntimeError(
                    "backend='torch' needs this process's default process "
                    "group: TorchConfig(distributed=True) in a gang, or "
                    "parallel.mesh.init_process_group")
            if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
                raise ValueError(
                    f"rank {rank}/{world_size} does not match the default "
                    f"process group's {dist.get_rank()}/"
                    f"{dist.get_world_size()}")

    # ---- host backend primitives -------------------------------------------

    def abort(self, reason: str = "aborted"):
        """Poison the group: every member blocked in (or later entering)
        a collective gets CollectiveAbortedError on its next poll."""
        if self._coord is not None:
            import ray_tpu_torch

            ray_tpu_torch.get(self._coord.abort.remote(reason))

    def _check_abort(self, reply):
        """Raise if the coordinator replied with the abort marker."""
        if (isinstance(reply, tuple) and len(reply) == 2
                and reply[0] == _ABORT):
            raise CollectiveAbortedError(
                f"collective group {self.name!r} aborted "
                f"(rank {self.rank}/{self.world_size}): {reply[1]}")
        return reply

    def _sync_op(self, data, op: str, timeout: float = 120.0):
        import ray_tpu_torch

        self._round += 1
        key = f"{op.split(':')[0]}:{self._round}"
        self._check_abort(ray_tpu_torch.get(
            self._coord.contribute.remote(key, self.rank, data, op),
            timeout=timeout,
        ))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            done, result = self._check_abort(ray_tpu_torch.get(
                self._coord.fetch.remote(key, self.rank), timeout=timeout
            ))
            if done:
                return result
            time.sleep(0.002)
        raise TimeoutError(
            f"collective {op} timed out in group {self.name!r} "
            f"(rank {self.rank}/{self.world_size})"
        )

    # ---- ring allreduce ------------------------------------------------------

    # Above this size the host backend switches from the star (everything
    # through the coordinator) to a RING: chunks hop peer-to-peer as
    # ObjectRefs, the shm store is the data plane, and the coordinator
    # mailbox only rendezvouses refs — O(N) total movement per member and
    # O(refs) coordinator memory instead of O(world x N) payloads.
    RING_THRESHOLD_BYTES = 1 << 20

    def _ring_allreduce(self, arr, op: str, timeout: float):
        import ray_tpu_torch

        W, r = self.world_size, self.rank
        self._round += 1
        base = self._round * 10_000
        flat = arr.reshape(-1)
        bounds = np.linspace(0, flat.shape[0], W + 1).astype(int)
        own = [flat[bounds[i]: bounds[i + 1]] for i in range(W)]
        own = [c.clone() if _is_tensor(c) else c.copy() for c in own]

        def send_chunk(chunk, tag):
            if not _is_tensor(chunk):
                chunk = np.ascontiguousarray(chunk)
            ref = ray_tpu_torch.put(chunk)
            # nested (listed) refs pass through UNRESOLVED, so the
            # coordinator mailbox holds the ref, never the payload
            self._check_abort(ray_tpu_torch.get(
                self._coord.post.remote(r, (r + 1) % W, tag, [ref])))

        def recv_chunk(tag):
            boxed = self.recv((r - 1) % W, tag=tag, timeout=timeout)
            got = ray_tpu_torch.get(boxed[0])
            return got if _is_tensor(got) else np.asarray(got)

        # phase 1: reduce-scatter around the ring
        for s in range(W - 1):
            send_chunk(own[(r - s) % W], base + s)
            idx = (r - s - 1) % W
            own[idx] = _reduce2(own[idx], recv_chunk(base + s), op)
        # phase 2: all-gather the reduced chunks
        for s in range(W - 1):
            send_chunk(own[(r + 1 - s) % W], base + 5000 + s)
            idx = (r - s) % W
            own[idx] = recv_chunk(base + 5000 + s)
        if _is_tensor(arr):
            import torch

            return torch.cat(own).reshape(arr.shape)
        return np.concatenate(own).reshape(arr.shape)

    # ---- torch backend -------------------------------------------------------

    @staticmethod
    def _dist_in(tensor):
        """A private copy of ``tensor`` on the process group's device."""
        import torch
        import torch.distributed as dist

        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        if not _is_tensor(tensor):
            tensor = torch.from_numpy(np.array(tensor))
        return tensor.detach().to(dev, copy=True).contiguous()

    @staticmethod
    def _dist_out(t, like):
        if _is_tensor(like):
            return t.to(like.device)
        return t.cpu().numpy()

    def _torch_allreduce(self, tensor, op: str):
        import torch.distributed as dist

        ops = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
               "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
        if op not in ops:
            raise ValueError(f"torch backend supports {list(ops)}, got {op!r}")
        t = self._dist_in(tensor)
        dist.all_reduce(t, ops[op])
        return t

    # ---- API ----------------------------------------------------------------

    def allreduce(self, tensor, op: str = "sum", timeout: float = 120.0):
        if self.backend == "torch":
            return self._dist_out(self._torch_allreduce(tensor, op), tensor)
        arr = _wire(tensor)
        nbytes = (arr.numel() * arr.element_size() if _is_tensor(arr)
                  else arr.nbytes)
        if (self.world_size > 1 and op in REDUCE_OPS
                and nbytes >= self.RING_THRESHOLD_BYTES):
            return _back(self._ring_allreduce(arr, op, timeout), tensor)
        return _back(self._sync_op(arr, op, timeout), tensor)

    def allgather(self, tensor, timeout: float = 120.0) -> List[Any]:
        """Every member's tensor, in rank order (the torch backend needs
        one shape on every rank)."""
        if self.backend == "torch":
            import torch
            import torch.distributed as dist

            t = self._dist_in(tensor)
            outs = [torch.empty_like(t) for _ in range(self.world_size)]
            dist.all_gather(outs, t)
            return [self._dist_out(o, tensor) for o in outs]
        parts = self._sync_op(_wire(tensor), "gather", timeout)
        return [_back(p, tensor) for p in parts]

    def reducescatter(self, tensor, op: str = "sum", timeout: float = 120.0):
        """This rank's block of the reduced tensor, split along axis 0 as
        ``np.array_split`` splits."""
        if self.backend == "torch":
            import torch

            full = self._torch_allreduce(tensor, op)
            block = torch.tensor_split(full, self.world_size, dim=0)[self.rank]
            return self._dist_out(block.contiguous(), tensor)
        full = self._sync_op(_wire(tensor), op, timeout)
        if _is_tensor(full):
            import torch

            block = torch.tensor_split(full, self.world_size, dim=0)
            return _back(block[self.rank].contiguous(), tensor)
        chunks = np.array_split(full, self.world_size, axis=0)
        return chunks[self.rank]

    def broadcast(self, tensor, src_rank: int = 0, timeout: float = 120.0):
        if self.backend == "torch":
            import torch.distributed as dist

            t = self._dist_in(tensor)
            dist.broadcast(t, src_rank)
            return self._dist_out(t, tensor)
        return _back(self._sync_op(_wire(tensor), f"bcast:{src_rank}",
                                   timeout), tensor)

    def barrier(self, timeout: float = 120.0):
        if self.backend == "torch":
            import torch.distributed as dist

            dist.barrier()
            return
        self._sync_op(None, "barrier", timeout)

    def _host_only(self, what: str):
        if self.backend != "host":
            raise ValueError(
                f"{what} runs on backend='host'; the torch backend carries "
                "the group's collectives only")

    def send(self, tensor, dst_rank: int, tag: int = 0):
        import ray_tpu_torch

        self._host_only("send")
        self._check_abort(ray_tpu_torch.get(
            self._coord.post.remote(self.rank, dst_rank, tag, _wire(tensor))
        ))

    def recv(self, src_rank: int, tag: int = 0, timeout: float = 120.0):
        import ray_tpu_torch

        self._host_only("recv")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ok, data = self._check_abort(ray_tpu_torch.get(
                self._coord.take.remote(src_rank, self.rank, tag)
            ))
            if ok:
                return data
            time.sleep(0.002)
        raise TimeoutError(f"recv from rank {src_rank} timed out")


def _coord_name(group_name: str, generation: int = 0) -> str:
    """Named-actor name for a group's coordinator. Generations let an
    elastic gang re-form the same logical group at a new world size
    without colliding with (or resurrecting the abort flag of) the
    previous incarnation's coordinator."""
    name = _COORD_PREFIX + group_name
    return name if generation == 0 else f"{name}@{generation}"


def _get_or_create_coordinator(group_name: str, world_size: int,
                               generation: int = 0):
    import ray_tpu_torch

    name = _coord_name(group_name, generation)
    try:
        return ray_tpu_torch.get_actor(name)
    except ValueError:
        pass
    try:
        coord_cls = ray_tpu_torch.remote(_Coordinator)
        return coord_cls.options(name=name).remote(world_size)
    except ValueError:
        # lost the creation race; the winner's actor is registered
        return ray_tpu_torch.get_actor(name)


def abort_group(group_name: str = "default", reason: str = "aborted",
                generation: int = 0) -> bool:
    """Driver-side: poison a group's coordinator so every member blocked
    in a collective fails over to CollectiveAbortedError within one poll
    interval (~ms), instead of stalling out the 120 s op timeout. Safe
    to call from a process that never joined the group. Returns False
    when no coordinator exists (nothing to abort)."""
    import ray_tpu_torch

    try:
        coord = ray_tpu_torch.get_actor(_coord_name(group_name, generation))
    except ValueError:
        return False
    ray_tpu_torch.get(coord.abort.remote(reason))
    return True


def destroy_coordinator(group_name: str = "default",
                        generation: int = 0) -> bool:
    """Driver-side: kill a group's coordinator actor (after members have
    drained). A later init at the same name starts from fresh state."""
    import ray_tpu_torch

    name = _coord_name(group_name, generation)
    try:
        coord = ray_tpu_torch.get_actor(name)
    except ValueError:
        return False
    ray_tpu_torch.kill(coord)
    # Wait until the name is actually deregistered: kill() is async, and
    # a fresh gang re-forming at the same name (cold restart after a
    # shrink below min_workers) must get-or-create a NEW coordinator, not
    # rendezvous with this dying one.
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        try:
            ray_tpu_torch.get_actor(name)
        except ValueError:
            return True
        time.sleep(0.02)
    return True


def init_collective_group(world_size: int, rank: int,
                          backend: str = "host",
                          group_name: str = "default",
                          generation: int = 0) -> CollectiveGroup:
    """Join a collective group (call once per member)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")
    group = CollectiveGroup(group_name, world_size, rank, backend, generation)
    _groups[group_name] = group
    return group


def get_group(group_name: str = "default") -> CollectiveGroup:
    if group_name not in _groups:
        raise ValueError(
            f"collective group {group_name!r} not initialized in this process"
        )
    return _groups[group_name]


def destroy_collective_group(group_name: str = "default"):
    _groups.pop(group_name, None)


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).allreduce(tensor, op)


def allgather(tensor, group_name: str = "default"):
    return get_group(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).reducescatter(tensor, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(tensor, src_rank)


def barrier(group_name: str = "default"):
    get_group(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default", tag: int = 0):
    get_group(group_name).send(tensor, dst_rank, tag)


def recv(src_rank: int, group_name: str = "default", tag: int = 0):
    return get_group(group_name).recv(src_rank, tag)
