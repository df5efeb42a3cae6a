"""The RLlib learners of the port: the device side of
``ray_tpu/rllib``.

Modules (``rl_module``: MLP, conv, Q, squashed-Gaussian, twin-Q) are
``nn.Module``s whose parameters move to and from the reference's numpy
trees; learners (PPO, IMPALA, APPO, DQN, SAC, BC, CQL, MARWIL, and
DreamerV3's world model and actor-critic) take numpy batches, run their
updates on the card (or the CPU when asked) and return the reference's
metrics as Python floats. The algorithm drivers and EnvRunners need the
task/actor runtime and wait for its port.
"""
