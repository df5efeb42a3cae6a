"""Collectives over the named axes of a mesh, differentiable.

Counterpart of ``ray_tpu/parallel/device_collectives.py``. The reference
calls ``jax.lax`` collectives inside ``shard_map``, whose ambient mesh
names the axes; PyTorch has no ambient mesh, so every function here
takes it: ``psum(x, "tp", mesh=mesh)``. An axis may be a tuple of mesh
axes (``("dp", "fsdp")``), combined dp-major as JAX combines them. Each
call is a collective: every rank of the axis's groups makes it, in the
same order. An axis of size 1 costs nothing.

Gradients are the transposes across ranks, the convention of
``torch.distributed.nn`` and of ``shard_map(check_vma=False)``: the
objective is the SUM of what every rank calls ``backward`` on, so
``psum`` transposes to ``psum``, ``all_gather`` to ``reduce_scatter``
(and back), ``all_to_all`` to the reverse ``all_to_all``, and
``ring_permute`` to the reverse permutation. ``pvary`` is the identity
whose gradient is summed over the axis: the step at which a value every
rank holds alike enters computation that differs by rank. ``pmax`` and
``pmin`` are not differentiable (nor are JAX's).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AxisName = Union[str, Sequence[str]]


def _axes(axis: AxisName) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _size(mesh, a: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(a))


def axis_size(axis: AxisName, *, mesh) -> int:
    n = 1
    for a in _axes(axis):
        n *= _size(mesh, a)
    return n


def axis_index(axis: AxisName, *, mesh) -> int:
    """This rank's index along the axis (dp-major over a tuple)."""
    idx = 0
    for a in _axes(axis):
        idx = idx * _size(mesh, a) + mesh.get_local_rank(a)
    return idx


def _live(mesh, axes) -> Tuple[str, ...]:
    return tuple(a for a in _axes(axes) if _size(mesh, a) > 1)


def _reduce(x: torch.Tensor, mesh, axes, op) -> torch.Tensor:
    out = x.contiguous().clone()
    for a in _live(mesh, axes):
        dist.all_reduce(out, op=op, group=mesh.get_group(a))
    return out


def _gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    # inner axes first, so that blocks land dp-major
    for a in reversed(_live(mesh, axes)):
        n = _size(mesh, a)
        # the backends want the blocks stacked along dim 0
        buf = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(buf, x.contiguous(),
                                    group=mesh.get_group(a))
        x = buf.unflatten(0, (n, x.shape[0])).movedim(0, dim).flatten(
            dim, dim + 1)
    return x


def _scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    # outer axes first: the transpose of _gather
    for a in _live(mesh, axes):
        n = _size(mesh, a)
        shape = list(x.shape)
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of size {shape[dim]} does not "
                             f"divide over axis {a!r} of size {n}")
        src = x.unflatten(dim, (n, shape[dim] // n)).movedim(dim, 0)
        shape[dim] //= n
        out = x.new_empty(shape)
        dist.reduce_scatter_tensor(out, src.flatten(0, 1).contiguous(),
                                   group=mesh.get_group(a))
        x = out
    return x


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _reduce(x, mesh, axes, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axes, dist.ReduceOp.SUM), None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axes, dist.ReduceOp.SUM), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def _a2a(x: torch.Tensor, mesh, a: str, split: int, concat: int):
    n = _size(mesh, a)
    if x.shape[split] % n:
        raise ValueError(f"dim {split} of size {x.shape[split]} does not "
                         f"split over axis {a!r} of size {n}")
    # chunk j of the split dim goes to rank j; what rank i sends lands in
    # block i of the concatenated dim
    src = x.unflatten(split, (n, x.shape[split] // n)).movedim(split, 0)
    out = torch.empty_like(src.contiguous())
    dist.all_to_all_single(out, src.contiguous(), group=mesh.get_group(a))
    return out.movedim(0, concat).flatten(concat, concat + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, a, split, concat):
        ctx.mesh, ctx.a, ctx.split, ctx.concat = mesh, a, split, concat
        return _a2a(x, mesh, a, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_a2a(g, ctx.mesh, ctx.a, ctx.concat, ctx.split), None, None,
                None, None)


def _peer(mesh, a: str, shift: int) -> int:
    """Global rank of the rank ``shift`` steps along axis ``a``."""
    d = mesh.mesh_dim_names.index(a)
    coord = list(mesh.get_coordinate())
    coord[d] = (coord[d] + shift) % mesh.size(d)
    return int(mesh.mesh[tuple(coord)])


def _permute(x: torch.Tensor, mesh, a: str, shift: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    group = mesh.get_group(a)
    ops = [dist.P2POp(dist.isend, x, _peer(mesh, a, shift), group),
           dist.P2POp(dist.irecv, out, _peer(mesh, a, -shift), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, a, shift):
        ctx.mesh, ctx.a, ctx.shift = mesh, a, shift
        return _permute(x, mesh, a, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.mesh, ctx.a, -ctx.shift), None, None, None


def psum(x: torch.Tensor, axis: AxisName, *, mesh) -> torch.Tensor:
    if not _live(mesh, axis):
        return x
    return _Psum.apply(x, mesh, _axes(axis))


def pmean(x: torch.Tensor, axis: AxisName, *, mesh) -> torch.Tensor:
    return psum(x, axis, mesh=mesh) / axis_size(axis, mesh=mesh)


def pmax(x: torch.Tensor, axis: AxisName, *, mesh) -> torch.Tensor:
    return _reduce(x.detach(), mesh, axis, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, axis: AxisName, *, mesh) -> torch.Tensor:
    return _reduce(x.detach(), mesh, axis, dist.ReduceOp.MIN)


def pvary(x: torch.Tensor, axis: AxisName, *, mesh) -> torch.Tensor:
    """Identity forward; the gradient is summed over the axis (JAX's
    ``pvary``, which transposes to ``psum``)."""
    if not _live(mesh, axis):
        return x
    return _Pvary.apply(x, mesh, _axes(axis))


def all_gather(x: torch.Tensor, axis: AxisName, *, mesh,
               gather_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Gather shards along ``gather_axis`` across the mesh axis (tiled:
    concatenated; else stacked in a new dim there)."""
    gather_axis %= x.dim()
    out = x if not _live(mesh, axis) else \
        _AllGather.apply(x, mesh, _axes(axis), gather_axis)
    if tiled:
        return out
    n = axis_size(axis, mesh=mesh)
    return out.unflatten(gather_axis, (n, x.shape[gather_axis]))


def reduce_scatter(x: torch.Tensor, axis: AxisName, *, mesh,
                   scatter_axis: int = 0) -> torch.Tensor:
    """Sum-reduce then scatter along ``scatter_axis`` (tiled)."""
    if not _live(mesh, axis):
        return x
    return _ReduceScatter.apply(x, mesh, _axes(axis), scatter_axis % x.dim())


def all_to_all(x: torch.Tensor, axis: str, *, mesh, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all (the Ulysses primitive): chunk ``j`` of
    ``split_axis`` goes to rank ``j``; the chunks received concatenate
    along ``concat_axis`` in rank order."""
    (a,) = _axes(axis)
    if _size(mesh, a) == 1:
        return x
    return _AllToAll.apply(x, mesh, a, split_axis % x.dim(),
                           concat_axis % x.dim())


def ring_permute(x: torch.Tensor, axis: str, shift: int = 1, *,
                 mesh) -> torch.Tensor:
    """Send this shard ``shift`` steps around the ring of the axis and
    receive from the opposite neighbour (one ``ppermute`` hop)."""
    (a,) = _axes(axis)
    n = _size(mesh, a)
    if shift % n == 0:
        return x
    return _RingPermute.apply(x, mesh, a, shift % n)


def ring_slice_exchange(kv: torch.Tensor, axis: str, *,
                        mesh) -> torch.Tensor:
    """One ring-attention step: pass the current KV block to the next
    rank; returns the block received from the previous rank."""
    return ring_permute(kv, axis, 1, mesh=mesh)


def pbroadcast(x: torch.Tensor, axis: str, src: int = 0, *,
               mesh) -> torch.Tensor:
    """Broadcast rank ``src``'s value across the axis (a masked psum)."""
    mine = torch.tensor(axis_index(axis, mesh=mesh) == src, device=x.device)
    return psum(torch.where(mine, x, torch.zeros_like(x)), axis, mesh=mesh)
