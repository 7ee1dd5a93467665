"""Distribution & sharding utilities.

The reference scales by forking one OS process per environment
(/root/reference/PyFlyt/rl_training/hovering/training.py:159-164,
SubprocVecEnv with pickle pipes). Here the scaling axis is a 1-D device
mesh over the environment batch (SURVEY.md §2.4 / §5): env state sharded
``P('env')``, learner replicated, collectives inserted by XLA (NCCL over
NVLink between the GPUs of one host).
"""

from pyflyt_tpu.parallel.mesh import (  # noqa: F401
    env_mesh,
    init_distributed,
    replicate,
    shard_env_batch,
)
