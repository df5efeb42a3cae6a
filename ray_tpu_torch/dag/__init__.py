"""Compiled DAGs: µs-dispatch static actor pipelines over shm channels.

The port's copy of ``ray_tpu/dag``: a static graph of actor method calls
is "compiled" into resident per-actor loops connected by seqno-gated
mutable shm channels, so a steady-state pipeline invocation costs
microseconds of shm handoff instead of a scheduler round trip per stage.
Edges between two stages of one GPU actor can stay on the card
(``DeviceChannel``: CUDA tensors by reference, ordered by a CUDA event).
This is the substrate Serve's DAG mode runs on. Cross-node edges
(``SocketChannel``) come with cluster mode (ROADMAP.md section 1, item
5).
"""

from ray_tpu_torch.dag.api import (CompiledDag, InputNode,  # noqa: F401
                                   MultiOutputNode, bind, compile_dag,
                                   compile_pipeline)
from ray_tpu_torch.dag.channel import (Channel, DeviceChannel,  # noqa: F401
                                       SocketChannel)
