"""RLlib on the port: the drivers users call, and the learners on the card.

Counterpart of ``ray_tpu/rllib``. The drivers (``PPOConfig()
.environment(...).build().train()``, and IMPALA, APPO, DQN, SAC,
multi-agent PPO, DreamerV3) run on the port's runtime: EnvRunner gangs
are plain CPU actors (``env_runner``) that act through the modules'
numpy ``apply_np`` on weights put in the object store, and every
learner runs on the card unless ``AlgorithmConfig.learners(device=)``
says otherwise (without CUDA, ``build()`` raises). The environments
(``envs``, ``multi_agent``), replay buffers and catalog are numpy
copies of the reference's.

Modules (``rl_module``: MLP, conv, Q, squashed-Gaussian, twin-Q) are
``nn.Module``s whose parameters move to and from the reference's numpy
trees; learners (PPO, IMPALA, APPO, DQN, SAC, BC, CQL, MARWIL, and
DreamerV3's world model and actor-critic) take numpy batches, run their
updates on their device and return the reference's metrics as Python
floats. The external-env ``PolicyClient`` / ``PolicyServerInput``
(``policy_server``) serve actions to environments outside the cluster
over the cluster's RPC layer and hand the caller's learner
IMPALA-schema batches.
"""

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig  # noqa: F401
from ray_tpu_torch.rllib.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rllib.catalog import Box, Catalog, Discrete  # noqa: F401
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rllib.dreamer import (DreamerV3,  # noqa: F401
                                         DreamerV3Config)
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig  # noqa: F401
from ray_tpu_torch.rllib.multi_agent import (MultiAgentPPO,  # noqa: F401
                                             MultiAgentPPOConfig)
from ray_tpu_torch.rllib.offline import (BCLearner,  # noqa: F401
                                         CQLLearner, MARWILLearner,
                                         train_offline)
from ray_tpu_torch.rllib.policy_server import (PolicyClient,  # noqa: F401
                                               PolicyServerInput)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.replay_buffer import (  # noqa: F401
    PrioritizedReplayBuffer, ReplayBuffer)
from ray_tpu_torch.rllib.rl_module import (MLPModule,  # noqa: F401
                                           QMLPModule,
                                           SquashedGaussianModule,
                                           TwinQModule)
from ray_tpu_torch.rllib.sac import SAC, SACConfig  # noqa: F401
