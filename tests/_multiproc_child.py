"""Child process for tests/test_multiprocess_mesh.py — NOT a test module.

Runs one process of a 2-process x 4-CPU-device jax.distributed cluster:

    python tests/_multiproc_child.py <coordinator_addr> <num_procs> <proc_id>

Exercises the only code path a single-process virtual mesh cannot:
``parallel.mesh.init_distributed`` (jax.distributed.initialize) plus global
array construction across process boundaries (SURVEY.md §4's multi-host
testing mandate, VERDICT r2 missing-item 3). Work done on the global
('env',) mesh:

1. one full PPO train iteration with env state sharded P('env') across both
   processes and params replicated (the pyflyt_tpu/rl/ppo.py program XLA
   partitions over several devices in production), and
2. one fused-kernel packed-hover rollout step under shard_map (interpret
   mode on the CPU; chip_smoke.py runs the compiled kernel on the GPU).

Prints one machine-readable line ``MPOK <loss> <reward_sum>`` on success;
the parent asserts both processes print identical values and that the loss
matches the single-process 8-device run.
"""

import sys

import jax


def main() -> None:
    coord, num_procs, proc_id = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    from pyflyt_tpu.parallel.mesh import env_mesh, init_distributed

    init_distributed(
        coordinator_address=coord,
        num_processes=num_procs,
        process_id=proc_id,
    )
    assert jax.process_count() == num_procs, jax.process_count()
    assert jax.device_count() == 8, jax.device_count()
    assert len(jax.local_devices()) == 4, jax.local_devices()

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = env_mesh()  # global 1-D ('env',) mesh spanning both processes

    def globalize(tree, num_envs):
        """Host-local pytree -> global arrays: leaves with a leading env
        axis shard P('env'), everything else replicates. Both processes
        hold identical host values (same PRNG seeds), so the callback just
        serves the requested index of the full array."""

        def leaf(x):
            x = np.asarray(x)
            spec = (
                P("env")
                if x.ndim >= 1 and x.shape[0] == num_envs
                else P()
            )
            s = NamedSharding(mesh, spec)
            return jax.make_array_from_callback(x.shape, s, lambda i: x[i])

        return jax.tree.map(leaf, tree)

    # --- 1. full PPO train iteration over the global mesh -----------------
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
    runner = ppo.init(jax.random.PRNGKey(0))  # identical on both processes
    runner = globalize(runner, 32)
    runner, metrics = jax.jit(ppo.train_iteration)(runner)
    loss = metrics["loss"]
    jax.block_until_ready(loss)
    # loss is fully replicated -> addressable everywhere
    loss_val = float(loss)
    assert np.isfinite(loss_val), loss_val

    # --- 2. packed fused-kernel rollout step under shard_map --------------
    from pyflyt_tpu.envs.packed_hover import PackedQuadXHoverEnv

    penv = PackedQuadXHoverEnv(base=QuadXHoverEnv(noisy_motors=False))
    n = 8 * jax.device_count()  # one folded lane-column per device
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    state, _ = penv.reset(keys)
    shard_keys = jax.random.split(jax.random.PRNGKey(2), num_procs * 4)
    action = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.36]), (n, 1))
    # explicit shardings: packed is (rows, 8, lanes) with lanes on 'env'
    packed_g = jax.make_array_from_callback(
        state.packed.shape,
        NamedSharding(mesh, P(None, None, "env")),
        lambda i: np.asarray(state.packed)[i],
    )
    keys_g = jax.make_array_from_callback(
        shard_keys.shape,
        NamedSharding(mesh, P("env")),
        lambda i: np.asarray(shard_keys)[i],
    )
    action_g = jax.make_array_from_callback(
        action.shape,
        NamedSharding(mesh, P("env")),
        lambda i: np.asarray(action)[i],
    )

    def local_step(packed, key, act):
        st = type(state)(packed=packed, key=key[0])
        st, out = penv.step(st, act)
        return st.packed, out.reward

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(None, None, "env"), P("env"), P("env")),
        out_specs=(P(None, None, "env"), P("env")),
        check_vma=False,
    )
    _, reward = jax.jit(sharded)(packed_g, keys_g, action_g)
    jax.block_until_ready(reward)

    # cross-process reduction to a replicated (hence addressable) total
    total = float(
        jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(reward)
    )
    assert np.isfinite(total), total

    print(f"MPOK {loss_val!r} {total!r}", flush=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
