"""True multi-process distributed-mesh test (SURVEY.md §4, VERDICT r2 #4).

Spawns TWO separate Python processes, each owning 4 virtual CPU devices,
joined into one 8-device cluster via ``jax.distributed.initialize``
(exercising ``parallel/mesh.py::init_distributed`` — the one code path a
single-process virtual mesh can never reach). Each child builds the global
``('env',)`` mesh, constructs cross-process global arrays, runs one sharded
PPO train iteration plus one packed fused-kernel rollout step, and reports
its replicated loss/reward. The parent asserts:

* both processes report bit-identical values (SPMD determinism), and
* the loss matches this process's own single-process 8-device run of the
  same program (partitioning must not change the math).

Reference analogue: the reference scales via SB3 SubprocVecEnv worker
processes (PyFlyt/rl_training/hovering/training.py:159-206); here the
equivalent axis is a jax.distributed process group over one jitted program.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_multiproc_child.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env() -> dict:
    """A clean CPU environment for the children: 4 virtual devices each,
    CPU platform selected before the backend initializes."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # repo root on the import path (pyflyt_tpu is not pip-installed)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_two_process_mesh_ppo_and_packed_rollout():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = _child_env()
    procs = [
        subprocess.Popen(
            [sys.executable, CHILD, coord, "2", str(pid)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=REPO,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-4000:]}"

    vals = []
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("MPOK ")]
        assert lines, out[-4000:]
        _, loss, reward = lines[0].split()
        vals.append((float(loss), float(reward)))

    # SPMD: both processes ran the same global program -> identical results
    assert vals[0] == vals[1], vals

    # equivalence vs the single-process 8-device run of the same program
    from jax.sharding import Mesh

    from pyflyt_tpu.envs.quadx_hover import QuadXHoverEnv
    from pyflyt_tpu.rl.ppo import PPO, PPOConfig

    ppo = PPO(
        QuadXHoverEnv(max_duration_seconds=1.0),
        PPOConfig(
            num_envs=32,
            rollout_steps=4,
            num_epochs=2,
            num_minibatches=2,
            feature_sizes=(32, 32),
        ),
    )
    runner = ppo.init(jax.random.PRNGKey(0))
    mesh = Mesh(np.array(jax.devices()[:8]), ("env",))
    runner = ppo.shard_runner(runner, mesh)
    _, metrics = jax.jit(ppo.train_iteration)(runner)
    ref_loss = float(metrics["loss"])
    assert np.isfinite(ref_loss)
    np.testing.assert_allclose(vals[0][0], ref_loss, rtol=2e-5)
