"""First-order optimizers with lean XLA graphs for scan-embedded loops.

A drop-in subset of the optax API (``init(params)`` / ``update(grads,
state, params)`` -> ``(updates, state)``, packaged as an
``optax.GradientTransformation``). On an H100 (NVIDIA H100 80GB HBM3,
400 W limit) it is no faster than ``optax.adam`` inside the fluA ELBO's
``lax.scan``: 0.728 ms per iteration with either (chunk=100), so its
removal is queued in ROADMAP.md. The math is standard Adam (Kingma & Ba
2015), the same
update rule as the reference's OPT_SG_ADAM ascent path
(src/phyc/gradascent.c:55-118, optimizer.c OPT_SG_ADAM).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax


class AdamState(NamedTuple):
    count: jnp.ndarray
    mu: Any
    nu: Any


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8,
         rsqrt_decay: bool = False) -> optax.GradientTransformation:
    """Adam with bias correction, one flat tree_map per moment.

    ``rsqrt_decay=True`` scales the step by 1/sqrt(t) — the reference's
    stochastic-Adam schedule (src/phyc/gradascent.c:257 ``eta_scaled = eta
    / sqrt(iter)``), which is what drives its ELBO fits below the
    constant-lr Monte-Carlo noise floor (~4 nats on the fluA config with
    one gradient sample)."""

    def init(params):
        return AdamState(
            jnp.zeros((), jnp.int32),
            jax.tree.map(jnp.zeros_like, params),
            jax.tree.map(jnp.zeros_like, params),
        )

    def update(grads, state, params=None):
        del params
        count = state.count + 1
        leaves = jax.tree.leaves(grads)
        tf = count.astype(leaves[0].dtype if leaves else jnp.float32)
        mu = jax.tree.map(lambda m, g: b1 * m + (1.0 - b1) * g,
                          state.mu, grads)
        nu = jax.tree.map(lambda v, g: b2 * v + (1.0 - b2) * g * g,
                          state.nu, grads)
        c1 = 1.0 - b1 ** tf
        c2 = 1.0 - b2 ** tf
        lr = learning_rate
        if rsqrt_decay:
            lr = lr * jax.lax.rsqrt(tf)
        updates = jax.tree.map(
            lambda m, v: (-lr) * (m / c1)
            / (jnp.sqrt(v / c2) + eps), mu, nu)
        return updates, AdamState(count, mu, nu)

    return optax.GradientTransformation(init, update)


def sgd(learning_rate: float, momentum: float = 0.0
        ) -> optax.GradientTransformation:
    """Plain (optionally momentum) SGD with the same lean-graph property."""

    def init(params):
        if momentum == 0.0:
            return ()
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        del params
        if momentum == 0.0:
            return jax.tree.map(lambda g: -learning_rate * g, grads), state
        vel = jax.tree.map(lambda v, g: momentum * v + g, state, grads)
        return jax.tree.map(lambda v: -learning_rate * v, vel), vel

    return optax.GradientTransformation(init, update)
