"""Device meshes over torch.distributed ranks.

Counterpart of ``ray_tpu/parallel/mesh.py``. The reference builds a
``jax.sharding.Mesh`` of devices; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of ranks (one process per
card, one process per virtual CPU device on the host) with
``mesh_dim_names`` in the reference's outer-to-inner axis order:

    "dp"    pure data parallel (replicated params)
    "fsdp"  data parallel with sharded params (ZeRO-3 style)
    "pp"    pipeline stages
    "sp"    sequence/context parallel (ring and Ulysses attention)
    "ep"    expert parallel (MoE)
    "tp"    tensor parallel (Megatron-style, innermost)

Every process first joins one process group (``init_process_group``):
NCCL when its device is a CUDA card, gloo when it is the CPU. Rank ``i``
stands where the reference puts device ``i``: ``build_mesh`` lays ranks
out in row-major order, as ``mesh_utils.create_device_mesh`` lays out
devices that carry no topology, and ``build_hybrid_mesh`` interleaves
contiguous pseudo-slices exactly as the reference's fallback does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "ep", "tp")

# Canonical groupings used by shardings and trainers.
DATA_AXES = ("dp", "fsdp")          # batch is sharded over these
MODEL_AXES = ("tp", "sp", "ep", "pp")


@dataclass(frozen=True)
class MeshSpec:
    """A named, ordered parallelism layout.

    Example::

        spec = MeshSpec(axes={"fsdp": 2, "tp": 4})
        mesh = build_mesh(spec)          # over every rank of the group
    """

    axes: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        for name in self.axes:
            if name not in AXIS_ORDER:
                raise ValueError(
                    f"unknown mesh axis {name!r}; valid axes: {AXIS_ORDER}"
                )
        if any(s <= 0 for s in self.axes.values()):
            raise ValueError(f"axis sizes must be positive: {self.axes}")

    @property
    def ordered(self) -> List[Tuple[str, int]]:
        """Axes in canonical outer->inner order."""
        return [(a, self.axes[a]) for a in AXIS_ORDER if a in self.axes]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.ordered)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.ordered)

    @property
    def size(self) -> int:
        n = 1
        for _, s in self.ordered:
            n *= s
        return n

    def with_axis(self, name: str, size: int) -> "MeshSpec":
        axes = dict(self.axes)
        axes[name] = size
        return MeshSpec(axes)

    @classmethod
    def data_parallel(cls, num_devices: int, sharded: bool = True
                      ) -> "MeshSpec":
        """All ranks on one data axis (fsdp if sharded else dp)."""
        return cls({"fsdp" if sharded else "dp": num_devices})

    @classmethod
    def from_devices(cls, num_devices: int, tp: int = 1, pp: int = 1,
                     sp: int = 1, ep: int = 1, dp: int = 0) -> "MeshSpec":
        """Fill the data axis with whatever ranks remain after model axes."""
        model = tp * pp * sp * ep
        if num_devices % model != 0:
            raise ValueError(
                f"{num_devices} devices not divisible by tp*pp*sp*ep={model}"
            )
        remaining = num_devices // model
        if dp and dp != remaining:
            raise ValueError(f"dp={dp} but only {remaining} devices remain")
        axes = {}
        for k, v in {"dp": remaining, "pp": pp, "sp": sp, "ep": ep,
                     "tp": tp}.items():
            if v > 1 or (k == "dp" and v >= 1):
                axes[k] = v
        return cls(axes)


def init_process_group(rank: int, world_size: int, device=None,
                       store_path: Optional[str] = None,
                       init_method: Optional[str] = None, timeout=None,
                       store=None):
    """Join this process to the default process group and return its
    device. The backend follows the device: NCCL for a CUDA card (``None``
    means the card; without one this raises), gloo for ``"cpu"``. The
    rendezvous is ``store`` (a ``torch.distributed.Store``) when given,
    a ``FileStore`` at ``store_path``, else ``init_method`` (default
    ``"env://"``: ``MASTER_ADDR`` / ``MASTER_PORT`` from the
    environment); no port is fixed here.
    ``timeout`` (a ``timedelta``, default torch's) bounds the rendezvous
    and every collective of the group."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    if store is None and store_path is not None:
        store = dist.FileStore(store_path, world_size)
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size, **kw)
    return device


def _device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world_ranks(devices: Optional[Sequence[int]]) -> List[int]:
    import torch.distributed as dist

    return list(range(dist.get_world_size())) if devices is None \
        else [int(d) for d in devices]


def _mesh(ranks, names):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_device_type(), torch.as_tensor(ranks),
                      mesh_dim_names=tuple(names))


def build_mesh(spec: MeshSpec, devices: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` for the spec over ``devices`` (global ranks,
    default every rank of the group), laid out row-major in the spec's
    outer->inner axis order. Every rank of the group calls it."""
    import numpy as np

    ranks = _world_ranks(devices)
    if spec.size != len(ranks):
        raise ValueError(
            f"mesh spec {dict(spec.axes)} needs {spec.size} devices, "
            f"got {len(ranks)}"
        )
    arr = np.array(ranks).reshape(spec.shape or (1,))
    return _mesh(arr, spec.axis_names or ("dp",))


def build_hybrid_mesh(ici: "MeshSpec | Dict[str, int]",
                      dcn: "MeshSpec | Dict[str, int]",
                      devices: Optional[Sequence[int]] = None):
    """Multi-slice mesh: ``dcn`` axes span slices, ``ici`` axes span the
    ranks within a slice. An axis present in both gets size dcn*ici with
    the DCN factor outermost. Ranks are grouped into ``prod(dcn)``
    contiguous pseudo-slices and laid out as the reference's pseudo-slice
    path lays out devices (interleave (dcn_0, ici_0, dcn_1, ici_1, ...),
    then merge), so rank ``i`` sits where the reference puts device
    ``i``."""
    import numpy as np

    ici = ici if isinstance(ici, MeshSpec) else MeshSpec(dict(ici))
    dcn = dcn if isinstance(dcn, MeshSpec) else MeshSpec(dict(dcn))
    ranks = _world_ranks(devices)
    names = tuple(a for a in AXIS_ORDER if a in ici.axes or a in dcn.axes)
    ici_shape = tuple(ici.axes.get(a, 1) for a in names)
    dcn_shape = tuple(dcn.axes.get(a, 1) for a in names)
    total = int(np.prod(ici_shape)) * int(np.prod(dcn_shape))
    if total != len(ranks):
        raise ValueError(
            f"hybrid mesh ici={dict(ici.axes)} x dcn={dict(dcn.axes)} "
            f"needs {total} devices, got {len(ranks)}")
    arr = np.array(ranks).reshape(dcn_shape + ici_shape)
    k = len(names)
    arr = arr.transpose([i // 2 if i % 2 == 0 else k + i // 2
                         for i in range(2 * k)])
    arr = arr.reshape(tuple(d * i for d, i in zip(dcn_shape, ici_shape)))
    return _mesh(arr, names)


def hybrid_mesh(dcn: Dict[str, int], **ici_axes):
    """Convenience: ``hybrid_mesh({"dp": 2}, fsdp=4)`` over every rank:
    2 slices of data parallelism, fsdp=4 inside each."""
    return build_hybrid_mesh(MeshSpec(dict(ici_axes)), MeshSpec(dict(dcn)))


def local_mesh(tp: int = 0, **axes):
    """Convenience: mesh over every rank of the group.

    ``local_mesh()`` -> pure fsdp over every rank;
    ``local_mesh(tp=4)`` -> tp=4, fsdp over the rest.
    """
    import torch.distributed as dist

    n = dist.get_world_size()
    if not axes and not tp:
        return build_mesh(MeshSpec.data_parallel(n))
    if tp:
        axes["tp"] = tp
    model = 1
    for v in axes.values():
        model *= v
    if n % model:
        raise ValueError(f"{n} devices not divisible by {axes}")
    if n // model > 1:
        axes = {"fsdp": n // model, **axes}
    return build_mesh(MeshSpec(axes))


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def data_shard_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    return tuple(a for a in DATA_AXES if a in mesh.mesh_dim_names)
