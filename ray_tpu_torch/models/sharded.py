"""The explicit SPMD pieces shared by the models' mesh paths.

The reference runs a model under a mesh by letting GSPMD partition one
global program. The port runs the same program on every rank with every
collective written out (``parallel/device_collectives.py``):

- params are DTensors placed by the model's ``param_shardings``; each
  layer gathers what it needs from its local shards before it runs:
  ``all_gather`` over the axes its shards are gathered on (whose
  backward reduce-scatters the gradient) and ``pvary`` over the axes it
  is replicated on (whose backward sums the gradient). The shards of the
  axes in ``keep`` stay local: Megatron tensor parallelism over ``tp``
  (wq/wk/wv/w_gate/w_up by columns, wo/w_down by rows then a ``psum``,
  the vocabulary of embed and head), experts over ``ep``;
- the batch is split over (dp, fsdp), dp-major, and the sequence over
  sp;
- the loss is the global token mean, the same value on every rank.

Gradients follow the collectives' convention: the objective is the sum
of what every rank differentiates. The loss every rank returns is the
global value, so its backward is scaled by 1/world (``_Objective``):
the world's copies then sum to one loss. A rank that backpropagated an
unscaled local partial loss through un-summed shards would get partial
gradients; the tests check fsdp gradients against the unsharded ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch.parallel import device_collectives as dc
from ray_tpu_torch.parallel.mesh import DATA_AXES


@dataclass(frozen=True)
class Spmd:
    """This rank's view of a mesh for one sharded forward: the axes whose
    weight shards stay local (``keep``), the sequence-parallel axis of
    attention (``seq_axis``), the placements of one layer's leaves
    (``layer_pl``, by name) and the axes a layer's weights are not
    summed over (``skip``: ``pp``, whose sum the stage split does)."""
    mesh: Any
    keep: Tuple[str, ...] = ()
    seq_axis: Optional[str] = None
    layer_pl: Optional[Dict[str, tuple]] = None
    skip: Tuple[str, ...] = ()

    def size(self, a: str) -> int:
        names = self.mesh.mesh_dim_names
        return self.mesh.size(names.index(a)) if a in names else 1

    def index(self, a: str) -> int:
        return dc.axis_index(a, mesh=self.mesh) if self.size(a) > 1 else 0

    def kept(self, *axes: str) -> Tuple[str, ...]:
        """Those of ``axes`` whose shards stay local and that split."""
        return tuple(a for a in axes if a in self.keep and self.size(a) > 1)

    @property
    def world(self) -> int:
        return self.mesh.size()

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in DATA_AXES if a in self.mesh.mesh_dim_names)

    @property
    def token_axes(self) -> Tuple[str, ...]:
        """The axes that split tokens: data, then the sequence."""
        seq = self.seq_axis
        return self.data_axes + ((seq,) if seq and self.size(seq) > 1
                                 else ())

    @property
    def tp(self) -> int:
        return self.size("tp") if "tp" in self.keep else 1

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum the partial products of row-split weights over tp."""
        return dc.psum(x, "tp", mesh=self.mesh) if self.tp > 1 else x

    def heads_local(self, num_heads: int, num_kv_heads: int) -> bool:
        """Whether this rank's column shards of wq/wk/wv are whole heads
        of whole GQA groups: tp divides the KV heads (and so the Q
        heads). Otherwise ``tp_gather`` the projections and keep this
        rank's ``tp_block`` of the attention output."""
        return self.tp == 1 or (num_heads % self.tp == 0
                                and num_kv_heads % self.tp == 0)

    def tp_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole last dim from its tp column shards (the gradient
        reduce-scatters back)."""
        return dc.all_gather(x, "tp", mesh=self.mesh, gather_axis=-1)

    def tp_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the last dim, as tp splits a column."""
        return x.chunk(self.tp, -1)[self.index("tp")]

    def weights(self, p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One layer's weights for compute, from its local shards."""
        return {k: gather(v, self.layer_pl[k], self, self.skip)
                for k, v in p.items()}

    def data_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch (dim 0), dp-major."""
        axes = self.data_axes
        n = dc.axis_size(axes, mesh=self.mesh)
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not divide over the "
                             f"data axes {axes} ({n})")
        return x.chunk(n, 0)[dc.axis_index(axes, mesh=self.mesh)] \
            if n > 1 else x

    def seq_chunk(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of the sequence (over ``seq_axis``, when the
        sequence is split)."""
        n = self.size(self.seq_axis) if self.seq_axis else 1
        if x.shape[dim] % n:
            raise ValueError(f"sequence length {x.shape[dim]} must be "
                             f"divisible by the mesh's sp={n}")
        return x.chunk(n, dim)[dc.axis_index(
            self.seq_axis, mesh=self.mesh)] if n > 1 else x


def gather(local: torch.Tensor, placements, spmd: Spmd,
           skip: Tuple[str, ...] = ()) -> torch.Tensor:
    """A weight for compute from this rank's shard: gathered over every
    axis it is sharded on except those in ``spmd.keep`` (inner axes
    first, so blocks of one dim land dp-major), marked ``pvary`` over
    every axis it is replicated on except those in ``skip``."""
    names = spmd.mesh.mesh_dim_names
    for a, pl in reversed(list(zip(names, placements))):
        if pl.is_shard() and a not in spmd.keep and spmd.size(a) > 1:
            local = dc.all_gather(local, a, mesh=spmd.mesh,
                                  gather_axis=pl.dim)
    summed = tuple(a for a, pl in zip(names, placements)
                   if pl.is_replicate() and a not in skip)
    return dc.pvary(local, summed, mesh=spmd.mesh)


def dtensor_leaf(p):
    """(local shard, placements) of a DTensor param leaf."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        raise TypeError(
            "under a mesh the params are DTensors: place them with "
            "parallel.device_put_sharded(params, param_shardings(cfg, "
            "mesh))")
    return p.to_local(), tuple(p.placements)


def check_placements(params, shardings, where: str = "") -> None:
    """Every leaf of ``params`` is a DTensor placed as ``shardings`` says
    (the layer code assumes the Megatron split of the rule table)."""
    for k, v in params.items():
        if isinstance(v, dict):
            check_placements(v, shardings[k], f"{where}{k}.")
            continue
        _, pl = dtensor_leaf(v)
        if v.device_mesh != shardings[k].mesh:
            raise ValueError(f"param {where}{k} lies on another mesh")
        if pl != tuple(shardings[k].placements):
            raise ValueError(f"param {where}{k} is placed {pl}, the model's "
                             f"param_shardings say {shardings[k].placements}")


def local_tree(params, spmd: Spmd):
    """Every DTensor leaf of ``params`` as this rank's compute weight,
    gathered once over the axes ``spmd`` does not keep (serving: the
    weights do not change, so no layer regathers them)."""
    if isinstance(params, dict):
        return {k: local_tree(v, spmd) for k, v in params.items()}
    return gather(*dtensor_leaf(params), spmd)


def zeros_sharded(shape, dtype, device, sharding):
    """A zero DTensor of global ``shape`` placed by ``sharding``; each
    rank allocates its own shard only (every split dim divides)."""
    from torch.distributed.tensor import DTensor

    local = list(shape)
    for a, pl in zip(sharding.mesh.mesh_dim_names, sharding.placements):
        if pl.is_shard():
            n = sharding.mesh.size(sharding.mesh.mesh_dim_names.index(a))
            if local[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"split over axis {a!r} of size {n}")
            local[pl.dim] //= n
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              sharding.mesh, sharding.placements,
                              run_check=False)


def layer_placements(layers: Dict[str, Any]) -> Dict[str, tuple]:
    """The placements of one layer's slice of each stacked leaf."""
    from torch.distributed.tensor import Shard

    out = {}
    for k, v in layers.items():
        _, pl = dtensor_leaf(v)
        if any(x.is_shard() and x.dim == 0 for x in pl):
            raise ValueError(f"layer stack {k} is sharded on its layer dim")
        out[k] = tuple(Shard(x.dim - 1) if x.is_shard() else x for x in pl)
    return out


def layer_shards(layers: Dict[str, Any], l: int) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s slice of each stacked leaf's local shard."""
    return {k: dtensor_leaf(v)[0][l] for k, v in layers.items()}


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, spmd: Spmd,
                vocab_size: int, dtype) -> torch.Tensor:
    """Token embedding from a table whose rows (the vocabulary) may be
    split over tp: each rank looks up the ids in its range, zeros the
    rest, and the ranks' rows are summed. Ids are clamped into the
    vocabulary first, as the reference's gather clamps them."""
    ids = ids.long().clamp(0, vocab_size - 1)
    if spmd.tp == 1:
        return table[ids].to(dtype)
    n = table.shape[0]
    lo = dc.axis_index("tp", mesh=spmd.mesh) * n
    inside = ((ids >= lo) & (ids < lo + n))[..., None]
    x = table[(ids - lo).clamp(0, n - 1)].to(dtype) * inside
    return dc.psum(x, "tp", mesh=spmd.mesh)


def vocab_nll(logits: torch.Tensor, targets: torch.Tensor,
              spmd: Spmd) -> torch.Tensor:
    """Token NLL from fp32 logits whose last dim (the vocabulary) may be
    split over tp: the log-sum-exp and the target's logit are summed over
    the ranks' blocks."""
    if spmd.tp == 1:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - logits.gather(-1, targets.long()[..., None])[..., 0]
    n = logits.shape[-1]
    m = dc.pmax(logits.amax(dim=-1), "tp", mesh=spmd.mesh)
    se = dc.psum(torch.exp(logits - m[..., None]).sum(dim=-1), "tp",
                 mesh=spmd.mesh)
    lo = dc.axis_index("tp", mesh=spmd.mesh) * n
    t = targets.long()
    inside = (t >= lo) & (t < lo + n)
    mine = logits.gather(-1, (t - lo).clamp(0, n - 1)[..., None])[..., 0]
    true = dc.psum(mine * inside, "tp", mesh=spmd.mesh)
    return m + torch.log(se) - true


class _Objective(torch.autograd.Function):
    """The global loss every rank holds: the value as it is, its gradient
    divided by the world size, so that the world's copies sum to one."""

    @staticmethod
    def forward(ctx, loss, world):
        ctx.world = world
        return loss.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.world, None


def global_mean(nll: torch.Tensor, mask: Optional[torch.Tensor],
                spmd: Spmd) -> torch.Tensor:
    """The mean of the token NLLs over the global batch (with a mask, the
    masked mean over ``max(mask.sum(), 1)`` tokens), from this rank's
    tokens: summed over the axes that split tokens."""
    axes = spmd.token_axes
    if mask is None:
        total = nll.numel() * dc.axis_size(axes, mesh=spmd.mesh)
        return dc.psum(nll.sum(), axes, mesh=spmd.mesh) / total
    mask = mask.to(nll.dtype)
    den = dc.psum(mask.sum().detach(), axes, mesh=spmd.mesh)
    return dc.psum((nll * mask).sum(), axes, mesh=spmd.mesh) / \
        den.clamp_min(1)


def objective(loss: torch.Tensor, spmd: Spmd) -> torch.Tensor:
    return _Objective.apply(loss, spmd.world)


def global_tensor(x):
    """The global value of a batch leaf: a DTensor's full tensor, or the
    tensor every rank passed."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def gather_tokens(x: torch.Tensor, spmd: Spmd) -> torch.Tensor:
    """This rank's [b, s_chunk, ...] block back to the global [B, S,
    ...]: gathered over sp (dim 1) and the data axes (dim 0)."""
    if spmd.seq_axis:
        x = dc.all_gather(x, spmd.seq_axis, mesh=spmd.mesh, gather_axis=1)
    return dc.all_gather(x, spmd.data_axes, mesh=spmd.mesh, gather_axis=0)
