"""Shared check for the fused kernels with noise on (interpret mode on the
CPU): not a test module."""

import jax
import numpy as np


def check_noisy_step(penv, keys, act, bound):
    """One noisy agent step: finite, deterministic for a seed, different for
    another seed, and for the median env within ``bound`` (abs, over every
    obs/reward leaf) of the step with the other seed — noise perturbs, it
    does not blow up (a rare env may cross a crash boundary and flip its
    reward, hence the median)."""
    st, _ = penv.reset(keys)
    step = jax.jit(penv.step)
    _, a = step(st, act)
    _, b = step(st, act)
    _, c = step(st.replace(key=jax.random.fold_in(st.key, 1)), act)
    leaves = lambda o: [np.asarray(x) for x in jax.tree.leaves((o.obs, o.reward))]  # noqa: E731
    per_env = 0.0
    for x, y, z in zip(leaves(a), leaves(b), leaves(c)):
        assert np.all(np.isfinite(x))
        np.testing.assert_array_equal(x, y)
        d = np.abs(x - z).reshape(x.shape[0], -1).max(axis=1)
        per_env = np.maximum(per_env, d)
    assert per_env.max() > 0.0
    assert np.median(per_env) < bound, np.median(per_env)
