"""Device-mesh sharding: site-pattern data parallelism.

The reference's only scaling axis is SIMD/OpenMP across site patterns inside
one process (reference: src/phyc/treelikelihood4.c SSE kernels,
treelikelihood.c:1426-1452 OpenMP). The device equivalent shards the
pattern axis of the tip partials and pattern weights over a
``jax.sharding.Mesh`` — exact because site likelihoods are independent given
the model; the weighted log-lik sum (reference: treelikelihood.c:1483-1486)
and every per-pattern gradient contribution become XLA all-reduces between
devices (NVLink on a multi-GPU host), inserted automatically by GSPMD from
the sharding annotations.

The tree, model parameters, and P matrices replicate; only ``[..., P]``
arrays shard. MCMC chains / temperature ladders use a second mesh axis
('chains') via vmap + sharding on the chain dimension.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def pattern_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the pattern (data) axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), ("patterns",))


def chain_pattern_mesh(n_chains: int, devices=None) -> Mesh:
    """2-D mesh: chains x patterns."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % n_chains:
        raise ValueError(f"{n} devices not divisible into {n_chains} chain groups")
    arr = np.array(devices).reshape(n_chains, n // n_chains)
    return Mesh(arr, ("chains", "patterns"))


def shard_patterns(mesh: Mesh, *arrays, axis_name: str = "patterns"):
    """Place arrays with their LAST axis sharded over the mesh's pattern axis.

    Pattern counts must be padded to a multiple of the axis size (use
    ``TreeLikelihood(pattern_pad_multiple=mesh.shape['patterns'])`` or the
    engine's ``pad_patterns``).
    """
    out = []
    for a in arrays:
        spec = P(*([None] * (a.ndim - 1) + [axis_name]))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out) if len(out) > 1 else out[0]


def replicate(mesh: Mesh, tree):
    """Replicate a pytree across the mesh (model parameters)."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sharding), tree)


def shard_tree_likelihood(tlk, mesh: Mesh, axis_name: str = "patterns"):
    """Shard a TreeLikelihood's pattern-indexed constants over ``mesh``.

    After this, any jitted function of the likelihood runs SPMD: XLA
    partitions the pruning einsums on the pattern axis and inserts the
    all-reduce at the weighted root sum.
    """
    n_dev = int(mesh.shape[axis_name])
    P_total = tlk.tip_partials.shape[-1]
    if P_total % n_dev:
        raise ValueError(
            f"padded pattern count {P_total} not divisible "
            f"by mesh axis {n_dev}; rebuild the likelihood "
            f"with pattern_pad_multiple={n_dev}"
        )
    tlk.tip_partials, tlk.weights = shard_patterns(
        mesh, tlk.tip_partials, tlk.weights, axis_name=axis_name
    )
    tlk.mesh = mesh
    return tlk
