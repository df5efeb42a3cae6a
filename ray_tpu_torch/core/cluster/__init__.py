"""Multi-node substrate: GCS control plane, per-node servers, TCP RPC.

The reference framework splits these across gcs_server
(src/ray/gcs/gcs_server/), raylet (src/ray/raylet/) and the object
manager (src/ray/object_manager/object_manager.h) talking gRPC; here the
same capabilities ride a framed-pickle TCP transport (rpc.py) and each
node embeds the single-node Runtime as its local scheduler. A node's
``"GPU"`` resource is its detected ``GpuSet``; the ``Cluster`` fixture
(fixture.py) gives cards only to the node ``add_node(gpus=...)`` names.
"""

from ray_tpu_torch.core.cluster.fixture import Cluster  # noqa: F401
