"""On-device RL training (PPO) for the functional envs.

On-device replacement for the reference's SB3 training stack
(/root/reference/PyFlyt/rl_training/)::

    from pyflyt_tpu.rl import PPO, PPOConfig, TrainConfig, train
    from pyflyt_tpu.envs import QuadXHoverEnv

    ppo = PPO(QuadXHoverEnv(), PPOConfig(num_envs=2048))
    runner = train(ppo, TrainConfig(total_timesteps=10_000_000))
"""

from pyflyt_tpu.rl.ppo import PPO, PPOConfig, RunnerState  # noqa: F401
from pyflyt_tpu.rl.train import TrainConfig, train  # noqa: F401
from pyflyt_tpu.rl import checkpoint  # noqa: F401
