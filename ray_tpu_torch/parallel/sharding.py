"""Logical-axis sharding rules -> DTensor placements.

Counterpart of ``ray_tpu/parallel/sharding.py``. Models name the dims of
each parameter and activation logically ("batch", "embed", "mlp",
"heads", "kv", "vocab", "seq", "expert", "stage"); a rule table maps the
names onto mesh axes. Where the reference builds a ``PartitionSpec``
(one entry per TENSOR dim) and a ``NamedSharding``, a DTensor wants one
placement per MESH dim: ``Shard(d)`` where logical dim ``d`` maps onto
that mesh axis, ``Replicate()`` elsewhere. A logical dim mapped to a
tuple of axes (``"batch"`` -> ``("dp", "fsdp")``) shards one tensor dim
over several mesh dims, dp-major, as JAX does.

``Sharding`` is the counterpart of ``NamedSharding``: a mesh and its
placements. ``device_put_sharded`` makes DTensors (``distribute_tensor``)
and ``with_logical_constraint`` re-places one (``redistribute``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

# (logical dim name, mesh axis or tuple of axes or None)
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("embed", "fsdp"),       # ZeRO-3: params sharded over fsdp on the embed dim
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv", None),
    ("qkv", "tp"),
    ("vocab", "tp"),
    ("expert", "ep"),
    ("stage", "pp"),
    (None, None),
)


class Sharding(NamedTuple):
    """A mesh and one DTensor placement per mesh dim."""
    mesh: Any
    placements: Tuple[Any, ...]


def resolve_axis(logical: Optional[str], mesh, rules=DEFAULT_RULES):
    """Map one logical dim to mesh axes present in ``mesh`` (else None)."""
    if logical is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    for name, target in rules:
        if name == logical:
            if target is None:
                return None
            if isinstance(target, str):
                return target if target in names else None
            present = tuple(a for a in target if a in names)
            return present if present else None
    return None


def logical_to_placements(logical_axes: Sequence[Optional[str]], mesh,
                          rules=DEFAULT_RULES) -> tuple:
    """('batch', 'seq', 'embed') -> one placement per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, logical in enumerate(logical_axes):
        target = resolve_axis(logical, mesh, rules)
        for a in ((target,) if isinstance(target, str) else target or ()):
            i = mesh.mesh_dim_names.index(a)
            if placements[i].is_shard():
                # a PartitionSpec can name it twice, a tensor cannot be
                # placed so (JAX refuses such a sharding too)
                raise ValueError(
                    f"mesh axis {a!r} would shard dims {placements[i].dim} "
                    f"and {dim} of {tuple(logical_axes)}")
            placements[i] = Shard(dim)
    return tuple(placements)


def placements_to_spec(placements, mesh, ndim: int) -> tuple:
    """The inverse view: per TENSOR dim, the tuple of mesh axes that shard
    it (outer first), or None: what the reference's ``PartitionSpec``
    says, with a single axis written as a 1-tuple."""
    spec = [()] * ndim
    for a, pl in zip(mesh.mesh_dim_names, placements):
        if pl.is_shard():
            spec[pl.dim] = spec[pl.dim] + (a,)
    return tuple(s or None for s in spec)


def named_sharding(mesh, *logical_axes, rules=DEFAULT_RULES) -> Sharding:
    """Sharding for logical dims, e.g. named_sharding(mesh, 'batch', None)."""
    return Sharding(mesh, logical_to_placements(logical_axes, mesh, rules))


def replicated(mesh) -> Sharding:
    return named_sharding(mesh)


def batch_sharding(mesh) -> Sharding:
    """Sharding for a [global_batch, ...] tensor over the data axes."""
    return named_sharding(mesh, "batch")


def with_logical_constraint(x, logical_axes: Sequence[Optional[str]],
                            mesh=None, rules=DEFAULT_RULES):
    """Place ``x`` by logical names: a DTensor is redistributed, a plain
    tensor (the same global value on every rank) distributed. Without a
    mesh ``x`` is returned as it is, as the reference does outside a
    mesh context."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if mesh is None:
        return x
    placements = logical_to_placements(logical_axes, mesh, rules)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements)


def _is_logical(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x))


def _tree_map(fn, tree, is_leaf):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def shard_pytree_like(logical_tree, mesh, rules=DEFAULT_RULES):
    """A ``Sharding`` tree from a tree of logical-axis tuples (None
    entries -> fully replicated)."""
    return _tree_map(
        lambda logical: named_sharding(mesh, *(logical or ()), rules=rules),
        logical_tree, _is_logical)


def device_put_sharded(tree, shardings):
    """Distribute a tree of tensors (each the same global value on every
    rank) by a matching tree of ``Sharding``s: a tree of DTensors."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: device_put_sharded(v, shardings[k])
                for k, v in tree.items()}
    return distribute_tensor(tree, shardings.mesh, shardings.placements)
