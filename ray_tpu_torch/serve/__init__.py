"""Serve on the port: model serving on the port's runtime.

The port's copy of ``ray_tpu/serve``, exporting the same names: a
controller actor reconciles deployments to their target replica counts
and health-checks them; handles route requests with power-of-two-choices
load balancing; dynamic batching happens in the router; stdlib HTTP and
gRPC proxies expose deployments; DAG mode (``LLMPipeline``,
``PipelineDeployment``) serves through compiled actor pipelines.
Deployments take ``num_gpus`` (the runtime's ``"GPU"`` resource) where
``ray_tpu`` has ``num_tpus``: a ``num_gpus=1`` replica is a GPU actor
whose worker sees its card as ``cuda:0``.

The replica bodies are the port's engines, each behind the submit /
collect / peek / cancel / stats / shutdown mailbox the router polls: the
continuous-batching dense engine (``llm_engine.LLMEngine``), the
paged-KV engine with prefix cache (``paged_engine.PagedLLMEngine``) and
the paged engine with disaggregated prefill workers
(``disagg.DisaggPagedEngine``). The first two also serve
tensor-parallel over several ranks (``tp``: the process group, the
command link and the weight scatter). Importing this package loads
neither torch nor the engines.

Overload behavior: deployments carry QoS config (priority class,
``max_queue_depth``, ``deadline_s``); routers run admission control and
shed with typed ``BackpressureError`` (429 + Retry-After at the HTTP
proxy) while a missing replica set surfaces ``ReplicaUnavailableError``
(503) — both re-exported here.
"""

from ray_tpu_torch.exceptions import (  # noqa: F401
    BackpressureError,
    ReplicaUnavailableError,
)
from ray_tpu_torch.serve.api import (  # noqa: F401
    Deployment,
    DeploymentHandle,
    batch,
    delete,
    deployment,
    get_deployment_handle,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.dag_mode import (  # noqa: F401
    LLMPipeline,
    PipelineDeployment,
)
from ray_tpu_torch.serve.config_deploy import (  # noqa: F401
    apply as deploy_config,
)
from ray_tpu_torch.serve.grpc_proxy import start_grpc, stop_grpc  # noqa: F401
from ray_tpu_torch.serve.multiplex import (  # noqa: F401
    get_multiplexed_model_id,
    multiplexed,
)

__all__ = [
    "BackpressureError", "Deployment", "DeploymentHandle", "LLMPipeline",
    "PipelineDeployment", "ReplicaUnavailableError",
    "batch", "delete", "deploy_config", "deployment",
    "get_deployment_handle", "get_multiplexed_model_id", "multiplexed",
    "run", "shutdown", "start", "start_grpc", "status", "stop_grpc",
]
