"""pyflyt_tpu.core.struct: frozen pytree dataclasses (flax.struct's API)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyflyt_tpu.core import struct


@struct.dataclass
class _S:
    a: jax.Array
    b: dict
    name: str = struct.field(pytree_node=False, default="x")
    gain: float = struct.field(pytree_node=False, default=0.5)


def _s():
    return _S(a=jnp.arange(3.0), b={"u": jnp.ones(2), "v": jnp.zeros(())})


def test_pytree_round_trip():
    s = _s()
    leaves, treedef = jax.tree_util.tree_flatten(s)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, _S) and back.name == "x" and back.gain == 0.5
    for x, y in zip(jax.tree.leaves(s), jax.tree.leaves(back)):
        np.testing.assert_array_equal(x, y)
    doubled = jax.tree.map(lambda x: 2 * x, s)
    np.testing.assert_array_equal(doubled.a, 2 * s.a)
    assert doubled.name == "x"


def test_static_fields_are_not_leaves():
    s = _s()
    assert len(jax.tree.leaves(s)) == 3
    other = s.replace(name="y")
    assert jax.tree.structure(s) != jax.tree.structure(other)


def test_replace_and_frozen():
    s = _s()
    t = s.replace(a=jnp.zeros(3), gain=2.0)
    np.testing.assert_array_equal(t.a, np.zeros(3))
    assert t.gain == 2.0 and s.gain == 0.5
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.a = jnp.ones(3)


def test_jit_cache_hit_and_static_retrace():
    traces = []

    @jax.jit
    def f(s):
        traces.append(s.name)
        return s.a * s.gain + s.b["u"].sum()

    s = _s()
    f(s)
    f(s.replace(a=jnp.ones(3)))  # new leaf values: cache hit
    assert traces == ["x"]
    f(s.replace(name="y"))  # new static value: retrace
    assert traces == ["x", "y"]


def test_tree_select_broadcasts_batch_mask():
    on = {"p": jnp.ones((4, 3)), "q": jnp.ones(4)}
    off = {"p": jnp.zeros((4, 3)), "q": jnp.zeros(4)}
    mask = jnp.asarray([True, False, True, False])
    out = struct.tree_select(mask, on, off)
    np.testing.assert_array_equal(out["p"][:, 0], [1, 0, 1, 0])
    np.testing.assert_array_equal(out["q"], [1, 0, 1, 0])
