"""Parallelism layer: meshes, shardings and collectives over
torch.distributed (counterpart of ``ray_tpu/parallel``).

- mesh: MeshSpec, process-group set-up, ``DeviceMesh`` construction
  (dp/fsdp/pp/sp/ep/tp) in the reference's axis order and rank layout
- sharding: logical-axis rules -> DTensor placements
- device_collectives: psum, all_gather, reduce_scatter, all_to_all,
  ring_permute ... over named mesh axes, differentiable
- pipeline: the GPipe schedule as one SPMD program

``parallel/collective.py`` (host-level groups across actors) waits for
the port's own actor runtime.
"""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    DATA_AXES,
    MODEL_AXES,
    MeshSpec,
    build_hybrid_mesh,
    build_mesh,
    data_shard_axes,
    hybrid_mesh,
    init_process_group,
    local_mesh,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    Sharding,
    batch_sharding,
    device_put_sharded,
    logical_to_placements,
    named_sharding,
    replicated,
    shard_pytree_like,
    with_logical_constraint,
)
