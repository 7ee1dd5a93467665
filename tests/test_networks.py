"""Plain-JAX policy networks (rl/networks.py) against the flax modules they
replace: the same parameter tree key for key, and the same outputs on the
same parameters; and archived ``.npz`` policies restore into them."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyflyt_tpu.rl import checkpoint
from pyflyt_tpu.rl.networks import ActorCritic, VisionActorCritic

ART = os.path.join(os.path.dirname(os.path.dirname(__file__)), "docs", "artifacts")


def _flax_modules():
    """The flax.linen modules the package used before (reference only)."""
    nn = pytest.importorskip("flax.linen")

    class MLP(nn.Module):
        sizes: tuple

        @nn.compact
        def __call__(self, x):
            for size in self.sizes:
                x = nn.tanh(nn.Dense(size)(x))
            return x

    def heads(mod, feat):
        pi = MLP((*mod.feature_sizes,), name="pi_trunk")(feat)
        mean = nn.Dense(mod.action_dim, name="pi_head")(pi)
        log_std = mod.param("log_std", nn.initializers.zeros, (mod.action_dim,))
        vf = MLP((*mod.feature_sizes,), name="vf_trunk")(feat)
        value = nn.Dense(1, name="vf_head")(vf)
        return mean, jnp.broadcast_to(log_std, mean.shape), value[..., 0]

    class FlaxAC(nn.Module):
        action_dim: int
        feature_sizes: tuple

        @nn.compact
        def __call__(self, obs):
            return heads(self, obs)

    class FlaxConv(nn.Module):
        features: int

        @nn.compact
        def __call__(self, x):
            k = self.param("kernel", nn.initializers.lecun_normal(),
                           (3, 3, x.shape[-1], self.features))
            b = self.param("bias", nn.initializers.zeros, (self.features,))
            return jax.lax.conv_general_dilated(
                x, k, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            ) + b

    class FlaxVision(nn.Module):
        action_dim: int
        image_offset: int
        image_shape: tuple
        conv_features: tuple
        feature_sizes: tuple

        @nn.compact
        def __call__(self, obs):
            c, h, w = self.image_shape
            i0, n = self.image_offset, c * h * w
            vec = jnp.concatenate([obs[..., :i0], obs[..., i0 + n:]], axis=-1)
            img = obs[..., i0:i0 + n].reshape(*obs.shape[:-1], c, h, w)
            x = jnp.moveaxis(img / 255.0, -3, -1)
            for i, f in enumerate(self.conv_features):
                x = nn.relu(FlaxConv(f, name=f"Conv_{i}")(x))
            feat = jnp.concatenate([x.reshape(*x.shape[:-3], -1), vec], axis=-1)
            return heads(self, feat)

    return FlaxAC, FlaxVision


def _same_tree(a, b):
    ka = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(a)[0]]
    kb = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(b)[0]]
    assert ka == kb
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype


def _same_outputs(ours, flax_mod, flax_params, obs):
    for g, w in zip(ours.apply(flax_params, obs), flax_mod.apply(flax_params, obs)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_actor_critic_matches_flax():
    FlaxAC, _ = _flax_modules()
    obs = jax.random.normal(jax.random.PRNGKey(0), (7, 21))
    ours = ActorCritic(action_dim=4, feature_sizes=(32, 16))
    ref = FlaxAC(action_dim=4, feature_sizes=(32, 16))
    ref_params = ref.init(jax.random.PRNGKey(1), obs[:1])
    _same_tree(ours.init(jax.random.PRNGKey(1), obs[:1]), ref_params)
    _same_outputs(ours, ref, ref_params, obs)


def test_vision_actor_critic_matches_flax():
    _, FlaxVision = _flax_modules()
    kw = dict(action_dim=4, image_offset=10, image_shape=(4, 9, 9),
              conv_features=(8, 16), feature_sizes=(16,))
    obs = jax.random.uniform(jax.random.PRNGKey(0), (3, 10 + 4 * 81 + 5),
                             maxval=255.0)
    ours, ref = VisionActorCritic(**kw), FlaxVision(**kw)
    ref_params = ref.init(jax.random.PRNGKey(1), obs[:1])
    _same_tree(ours.init(jax.random.PRNGKey(1), obs[:1]), ref_params)
    _same_outputs(ours, ref, ref_params, obs)


def test_init_is_seeded_and_scaled():
    net = ActorCritic(action_dim=3, feature_sizes=(64, 64), init_log_std=-1.6)
    obs = jnp.zeros((1, 12))
    a = net.init(jax.random.PRNGKey(0), obs)
    b = net.init(jax.random.PRNGKey(0), obs)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)
    p = a["params"]
    k = np.asarray(p["pi_trunk"]["Dense_1"]["kernel"])
    np.testing.assert_allclose(k.T @ k, 2.0 * np.eye(64), atol=1e-4)  # orthogonal(sqrt 2)
    np.testing.assert_array_equal(p["log_std"], np.full(3, -1.6, np.float32))
    assert float(np.abs(p["pi_head"]["kernel"]).max()) < 0.05  # orthogonal(0.01)


def test_archived_policy_restores_and_acts():
    """A converted archived checkpoint (trajectory-slow, 64/64/32/32 net)
    restores into the plain network and gives finite actions."""
    net = ActorCritic(action_dim=4, feature_sizes=(64, 64), pi_sizes=(32, 32),
                      vf_sizes=(32, 32))
    path = os.path.join(ART, "policies_traj_slow_r4_seed0")
    raw = np.load(checkpoint.checkpoint_file(path))
    obs_dim = raw[".params['params']['pi_trunk']['Dense_0']['kernel']"].shape[0]
    template = net.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_dim)))
    params = checkpoint.restore_params(path, template)
    mean, log_std, value = net.apply(params, jnp.ones((5, obs_dim)))
    assert mean.shape == (5, 4) and value.shape == (5,)
    assert np.all(np.isfinite(np.asarray(mean)))
    bad = ActorCritic(action_dim=4, feature_sizes=(64, 64))
    with pytest.raises(ValueError):
        checkpoint.restore_params(path, bad.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_dim))))
