"""Multi-device parity: logP and gradients must match between one device and
a sharded mesh.

The reference's SIMD/OpenMP pattern loop reduces site log-likelihoods with a
weighted sum (reference: src/phyc/treelikelihood.c:1483-1486); sharding the
pattern axis over a mesh makes that sum a psum and must not change the value.
These tests run on the virtual 8-device CPU mesh provisioned by conftest.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physher_tpu.models.clock import StrictClock
from physher_tpu.models.sitemodel import GammaSiteModel
from physher_tpu.models.substitution import GTR, JC69
from physher_tpu.models.treelikelihood import TreeLikelihood
from physher_tpu.parallel.mesh import (
    chain_pattern_mesh, pattern_mesh, replicate, shard_tree_likelihood,
)
from physher_tpu.trees.timetree import TimeTreeData
from physher_tpu.utils.synthetic import balanced_topology, random_sitepattern

N_DEV = 8


def _require_devices():
    if len(jax.devices()) < N_DEV:
        pytest.skip(f"needs {N_DEV} virtual devices")


def _fixed_tree_tlk(dtype, pad):
    topo = balanced_topology(16)
    sp = random_sitepattern(16, 96, seed=3)
    return TreeLikelihood(
        sp, topo, GTR(), GammaSiteModel(4), rescale=True,
        pattern_pad_multiple=pad, dtype=dtype)


def _time_tree_tlk(dtype, pad):
    topo = balanced_topology(16)
    sp = random_sitepattern(16, 96, seed=5)
    heights = np.zeros(topo.N)
    for k in range(topo.I):
        cs = topo.children[k, : topo.child_count[k]]
        heights[topo.T + k] = heights[cs].max() + 0.4
    td = TimeTreeData.from_heights(topo, heights)
    return TreeLikelihood(
        sp, topo, JC69(), GammaSiteModel(4),
        clock=StrictClock(topo.N, rate_init=1e-2), time_data=td,
        include_jacobian=True, rescale=True,
        pattern_pad_multiple=pad, dtype=dtype)


def _value_and_grads(tlk, params):
    f = jax.jit(jax.value_and_grad(tlk.log_likelihood))
    val, grads = f(params)
    return np.asarray(val, np.float64), jax.tree_util.tree_map(
        lambda g: np.asarray(g, np.float64), grads)


def _assert_tree_close(a, b, rtol, atol=0.0):
    flat_a = jax.tree_util.tree_leaves(a)
    flat_b = jax.tree_util.tree_leaves(b)
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


@pytest.mark.parametrize("build", [_fixed_tree_tlk, _time_tree_tlk],
                         ids=["fixed", "time"])
def test_xla_engine_sharded_matches_single_device(build):
    """f64 XLA engine: logP + grad identical on 1 device vs 8-device mesh."""
    _require_devices()
    base = build(jnp.float64, pad=N_DEV)
    params = base.param_space().init_params()
    v0, g0 = _value_and_grads(base, params)

    shd = build(jnp.float64, pad=N_DEV)
    shard_tree_likelihood(shd, pattern_mesh(N_DEV))
    params_r = replicate(pattern_mesh(N_DEV), params)
    v1, g1 = _value_and_grads(shd, params_r)

    np.testing.assert_allclose(v1, v0, rtol=1e-14)
    _assert_tree_close(g1, g0, rtol=1e-11, atol=1e-12)


def test_chain_pattern_mesh_vmapped_chains():
    """2-D chains x patterns mesh: per-chain logP matches unsharded values."""
    _require_devices()
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_chains = 2
    mesh = chain_pattern_mesh(n_chains)
    tlk = _fixed_tree_tlk(jnp.float64, pad=mesh.shape["patterns"])
    shard_tree_likelihood(tlk, mesh)
    space = tlk.param_space()
    params = space.init_params()

    def stack(leaf):
        batched = jnp.broadcast_to(leaf, (n_chains,) + leaf.shape)
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            offs = jnp.arange(n_chains, dtype=leaf.dtype).reshape(
                (n_chains,) + (1,) * leaf.ndim) * 0.01
            batched = batched + offs
        return jax.device_put(
            batched, NamedSharding(mesh, P(*(["chains"] + [None] * leaf.ndim))))

    batch = jax.tree_util.tree_map(stack, params)
    vals = jax.jit(jax.vmap(tlk.log_likelihood))(batch)

    ref = _fixed_tree_tlk(jnp.float64, pad=mesh.shape["patterns"])
    for c in range(n_chains):
        pc = {k: np.asarray(v)[c] for k, v in batch.items()}
        pc = {k: jnp.asarray(v if np.ndim(v) else float(v))
              for k, v in pc.items()}
        np.testing.assert_allclose(
            float(vals[c]), float(ref.log_likelihood(pc)), rtol=1e-13)


@pytest.mark.parametrize("build", [_fixed_tree_tlk, _time_tree_tlk],
                         ids=["fixed", "time"])
def test_xla_engine_sharded_matches_single_device_f32(build):
    """f32: logP + grad on an 8-device mesh agree with one device to f32
    rounding (the sharded root sum adds in another order)."""
    _require_devices()
    base = build(jnp.float32, pad=N_DEV)
    params = base.param_space().init_params(dtype=jnp.float32)
    v0, g0 = _value_and_grads(base, params)

    shd = build(jnp.float32, pad=N_DEV)
    shard_tree_likelihood(shd, pattern_mesh(N_DEV))
    v1, g1 = _value_and_grads(shd, replicate(pattern_mesh(N_DEV), params))

    np.testing.assert_allclose(v1, v0, rtol=2e-6)
    _assert_tree_close(g1, g0, rtol=5e-4, atol=5e-5)


def test_shard_tree_likelihood_rejects_indivisible_padding():
    _require_devices()
    tlk = _fixed_tree_tlk(jnp.float64, pad=1)   # 96 patterns, 8 | 96
    odd = _fixed_tree_tlk(jnp.float64, pad=5)   # 100 patterns
    assert tlk.tip_partials.shape[-1] == 96
    shard_tree_likelihood(tlk, pattern_mesh(N_DEV))
    with pytest.raises(ValueError, match="not divisible"):
        shard_tree_likelihood(odd, pattern_mesh(N_DEV))
