"""Variational inference: ADVI with mean-field / full-rank normal families.

Rebuild of the reference's variational stack (reference: src/phyc/vb.c
variational_t + blocks, src/phyc/klqp.c reverse-KL ELBO with the
reparameterization trick, multi-sample ELBO klqp.h:17-19, transforms +
log-Jacobians src/phyc/transforms.c). The variational posterior lives on the
unconstrained space of a ParamSpace; constrain() + log_jacobian reproduce the
reference's transform bookkeeping (klqp.c:340-430).

The variational family is itself a model: ``elbo`` plays logP, its gradient
is the reparameterized grad-ELBO, and ``sample`` supports importance
sampling / posterior draws (reference: vb.c:1000-1092 — the Variational
object IS a Model). Everything is jitted; chains of ELBO gradient steps run
as one fused scan.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..utils.optim import adam as fast_adam

from ..models.parameters import ParamSpace

LOG_2PI = math.log(2.0 * math.pi)


@dataclass
class VBResult:
    vparams: dict
    elbo: float
    iterations: int
    history: list = field(default_factory=list)


class MeanFieldNormalVB:
    """Fully-factorized normal over the unconstrained space (reference:
    klqp.c klqp_block_meanfield_normal_*)."""

    def __init__(self, log_prob: Callable, space: ParamSpace, params: dict,
                 init_sigma: float = 0.1):
        self.log_prob = log_prob
        self.space = space
        self.dim = space.unconstrained_size
        u0 = space.flatten_unconstrained(space.unconstrain(params))
        self.init = {
            "loc": jnp.asarray(u0),
            "log_scale": jnp.full(self.dim, jnp.log(init_sigma),
                                  dtype=u0.dtype),
        }

    def _target(self, z):
        uparams = self.space.unflatten_unconstrained(z)
        return (self.log_prob(self.space.constrain(uparams))
                + self.space.log_jacobian(uparams))

    def sample_unconstrained(self, vparams, key, n: int):
        eps = jax.random.normal(key, (n, self.dim),
                                dtype=vparams["loc"].dtype)
        return vparams["loc"] + jnp.exp(vparams["log_scale"]) * eps

    def log_q(self, vparams, z):
        scale = jnp.exp(vparams["log_scale"])
        r = (z - vparams["loc"]) / scale
        return jnp.sum(-0.5 * (LOG_2PI + r * r) - vparams["log_scale"], -1)

    def entropy(self, vparams):
        return jnp.sum(vparams["log_scale"]) + 0.5 * self.dim * (1.0 + LOG_2PI)

    def elbo(self, vparams, key, n_samples: int = 1):
        z = self.sample_unconstrained(vparams, key, n_samples)
        lp = jax.vmap(self._target)(z)
        return jnp.mean(lp) + self.entropy(vparams)

    def sample(self, vparams, key, n: int):
        """Constrained-space posterior draws + their log q (for IS)."""
        z = self.sample_unconstrained(vparams, key, n)
        logq = self.log_q(vparams, z) - jax.vmap(
            lambda zz: self.space.log_jacobian(
                self.space.unflatten_unconstrained(zz)))(z)
        params = jax.vmap(
            lambda zz: self.space.constrain(
                self.space.unflatten_unconstrained(zz)))(z)
        return params, logq


class FullRankNormalVB(MeanFieldNormalVB):
    """Multivariate normal with Cholesky scale (reference: klqp.c fullrank +
    vb.c multivariatenormal block)."""

    def __init__(self, log_prob, space, params, init_sigma: float = 0.1):
        super().__init__(log_prob, space, params, init_sigma)
        d = self.dim
        self.tril_idx = np.tril_indices(d, -1)
        self.init = {
            "loc": self.init["loc"],
            "log_diag": jnp.full(d, jnp.log(init_sigma)),
            "off": jnp.zeros(len(self.tril_idx[0])),
        }

    def _scale_tril(self, vparams):
        d = self.dim
        L = jnp.zeros((d, d), dtype=vparams["loc"].dtype)
        L = L.at[self.tril_idx].set(vparams["off"])
        return L + jnp.diag(jnp.exp(vparams["log_diag"]))

    def sample_unconstrained(self, vparams, key, n: int):
        eps = jax.random.normal(key, (n, self.dim),
                                dtype=vparams["loc"].dtype)
        L = self._scale_tril(vparams)
        return vparams["loc"] + eps @ L.T

    def log_q(self, vparams, z):
        L = self._scale_tril(vparams)
        y = jax.scipy.linalg.solve_triangular(
            L, (z - vparams["loc"]).T, lower=True).T
        return (-0.5 * jnp.sum(y * y, -1)
                - 0.5 * self.dim * LOG_2PI - jnp.sum(vparams["log_diag"]))

    def entropy(self, vparams):
        return jnp.sum(vparams["log_diag"]) + 0.5 * self.dim * (1.0 + LOG_2PI)


class GammaMeanFieldVB(MeanFieldNormalVB):
    """Fully-factorized gamma family (reference: src/phyc/gamvi.c — gamma
    meanfield via the Generalized Reparameterization Gradient).

    Design: the block lives on the *unconstrained* space as a
    log-gamma — z = log g with g ~ Gamma(alpha, rate beta) has full support
    on R, and for a positive parameter (z = log x) the induced distribution
    on x is exactly the reference's Gamma(alpha, beta). Sampling uses
    ``jax.random.gamma``, whose implicit-reparameterization gradient replaces
    the reference's hand-derived GRG correction terms (gamvi.c:12-30).
    """

    def __init__(self, log_prob, space, params, init_shape: float = 10.0):
        super().__init__(log_prob, space, params)
        u0 = self.init["loc"]
        alpha0 = jnp.full(self.dim, init_shape, dtype=u0.dtype)
        # match the mode: log(alpha/beta) ~= u0 => beta = alpha * exp(-u0)
        self.init = {
            "log_alpha": jnp.log(alpha0),
            "log_beta": jnp.log(alpha0) - u0,
        }

    def sample_unconstrained(self, vparams, key, n: int):
        alpha = jnp.exp(vparams["log_alpha"])
        g = jax.random.gamma(key, alpha, (n, self.dim),
                             dtype=vparams["log_alpha"].dtype)
        return jnp.log(g) - vparams["log_beta"]

    def log_q(self, vparams, z):
        alpha = jnp.exp(vparams["log_alpha"])
        beta = jnp.exp(vparams["log_beta"])
        # log-gamma density: b^a/Gamma(a) exp(a z - b e^z)
        return jnp.sum(alpha * vparams["log_beta"]
                       - jax.scipy.special.gammaln(alpha)
                       + alpha * z - beta * jnp.exp(z), -1)

    def entropy(self, vparams):
        alpha = jnp.exp(vparams["log_alpha"])
        # -E[log q(z)] in closed form: E[z] = digamma(a) - log b,
        # E[e^z] = a/b
        elogq = (alpha * jax.scipy.special.digamma(alpha) - alpha
                 - jax.scipy.special.gammaln(alpha))
        return -jnp.sum(elogq)


class WeibullMeanFieldVB(MeanFieldNormalVB):
    """Fully-factorized Weibull family (reference: src/phyc/weibullvi.c
    klqp_block_meanfield_weibull_* with qweibull inverse-CDF sampling).

    x ~ Weibull(shape k, scale lam) on the positive axis, expressed on the
    unconstrained space as z = log x (full support). The inverse-CDF
    x = lam * (-log(1-u))^(1/k) is an explicit reparameterization
    (weibullvi.c:17-19), so gradients flow through sampling directly.
    """

    def __init__(self, log_prob, space, params, init_shape: float = 5.0):
        super().__init__(log_prob, space, params)
        u0 = self.init["loc"]
        k0 = jnp.full(self.dim, init_shape, dtype=u0.dtype)
        self.init = {"log_shape": jnp.log(k0), "log_scale": u0}

    def sample_unconstrained(self, vparams, key, n: int):
        k = jnp.exp(vparams["log_shape"])
        u = jax.random.uniform(key, (n, self.dim),
                               dtype=vparams["log_shape"].dtype,
                               minval=1e-12, maxval=1.0 - 1e-12)
        return vparams["log_scale"] + jnp.log(-jnp.log1p(-u)) / k

    def log_q(self, vparams, z):
        k = jnp.exp(vparams["log_shape"])
        y = z - vparams["log_scale"]          # log(x/lam)
        # Weibull logpdf in x plus Jacobian x of z = log x:
        # log k + k*log(x/lam) - (x/lam)^k
        return jnp.sum(vparams["log_shape"] + k * y - jnp.exp(k * y), -1)

    def entropy(self, vparams):
        k = jnp.exp(vparams["log_shape"])
        # entropy of z = log x: Euler-gamma*(1 - 1/k)... derive from
        # -E[log q]: E[k*y] = -euler_gamma + ... use closed form:
        # y = log(x/lam), e^{k y} ~ Exp(1) => E[e^{ky}] = 1,
        # E[k y] = E[log Exp(1)] = -euler_gamma
        euler = 0.5772156649015329
        return jnp.sum(-vparams["log_shape"] + euler + 1.0)


def fit_klpq(vb, key, *, steps: int = 2000, learning_rate: float = 0.05,
             n_samples: int = 32, log_every: int = 0) -> VBResult:
    """Forward-KL variational fit: minimize KL(p || q) (reference:
    src/phyc/klpq.c grad_klpq_normal_meanfield).

    Gradient of E_p[log q] estimated by self-normalized importance sampling
    with q as proposal: w_i = p(z_i)/q(z_i) (normalized, stop-gradiented),
    loss = -sum_i w_i log q(z_i).
    """
    opt = fast_adam(learning_rate)
    vparams = vb.init
    state = opt.init(vparams)

    def loss_fn(vp, key):
        z = vb.sample_unconstrained(vp, key, n_samples)
        z = jax.lax.stop_gradient(z)
        logq = vb.log_q(vp, z)
        logp = jax.vmap(vb._target)(z)
        logw = jax.lax.stop_gradient(logp - logq)
        w = jax.nn.softmax(logw)
        return -jnp.sum(w * logq), jnp.sum(w * (logp - logq))

    @jax.jit
    def step(vparams, state, key):
        (loss, kl), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            vparams, key)
        updates, state = opt.update(grads, state, vparams)
        return optax.apply_updates(vparams, updates), state, kl

    history = []
    kl = jnp.nan
    for it in range(steps):
        key, sub = jax.random.split(key)
        vparams, state, kl = step(vparams, state, sub)
        if log_every and (it + 1) % log_every == 0:
            history.append(float(kl))
            print(f"iter {it+1} E_w[logp-logq] {float(kl):.4f}")
    return VBResult(vparams, float(kl), steps, history)


def _fit_compiled(vb, *, learning_rate, grad_samples, chunk, elbo_samples,
                  rsqrt_decay):
    """Compiled step / chunk / eval functions, cached PER FAMILY INSTANCE.

    ``fit`` used to define fresh ``@jax.jit`` closures on every call, so
    every fit — including a timed one right after a warmup — paid full
    XLA recompilation (~2 s on fluA; BENCH_r04's 434 it/s "throughput"
    was really compile time over 1000 steps). Caching on the instance
    makes repeat fits steady-state: the honest fluA rate is ~6000 it/s.
    """
    cache = getattr(vb, "_fit_cache", None)
    if cache is None:
        cache = vb._fit_cache = {}
    ck = (learning_rate, grad_samples, chunk, elbo_samples, rsqrt_decay)
    if ck in cache:
        return cache[ck]

    opt = fast_adam(learning_rate, rsqrt_decay=rsqrt_decay)

    @jax.jit
    def step(vparams, state, key):
        val, grads = jax.value_and_grad(
            lambda vp: -vb.elbo(vp, key, grad_samples))(vparams)
        updates, state = opt.update(grads, state, vparams)
        return optax.apply_updates(vparams, updates), state, -val

    @jax.jit
    def run_chunk(vparams, state, key):
        def body(carry, k):
            vp, st = carry
            vp, st, val = step(vp, st, k)
            return (vp, st), val

        keys = jax.random.split(key, chunk)
        (vparams, state), vals = jax.lax.scan(body, (vparams, state), keys)
        return vparams, state, vals[-1]

    @jax.jit
    def eval_elbo(vparams, key):
        return vb.elbo(vparams, key, elbo_samples)

    cache[ck] = (opt, step, run_chunk, eval_elbo)
    return cache[ck]


def fit(vb, key, *, steps: int = 5000, learning_rate: float = 0.02,
        grad_samples: int = 1, elbo_samples: int = 100,
        elbo_every: int = 100, tol: float = 1e-4, patience: int = 10,
        log_every: int = 0, chunk: int = 0,
        rsqrt_decay: bool = True, mesh=None) -> VBResult:
    """Adam on the negative ELBO (reference: optimizer.c OPT_SG_ADAM +
    gradascent.c loop with periodic multi-sample ELBO checks).

    ``chunk > 1`` runs that many Adam steps per device dispatch inside
    ``lax.scan`` — on small models (fluA: 238 patterns) per-step dispatch
    latency dominates an accelerator run, so chunking is what makes device VI
    competitive with the reference's in-cache CPU loop. Early stopping then
    happens at chunk granularity (``elbo_every`` is rounded up).

    ``rsqrt_decay`` (default on) applies the reference's eta/sqrt(t)
    schedule (gradascent.c:257): with one-sample gradients a constant lr
    stalls ~4 nats above the optimum on the fluA ELBO config.

    ``mesh``: replicate the variational parameters over a device mesh so
    the fit runs sharded end-to-end — the target's TreeLikelihood
    constants carry the pattern-axis sharding (parallel.mesh.
    shard_tree_likelihood) and GSPMD inserts the psum at the weighted
    root reduction (reference reduction point:
    src/phyc/treelikelihood.c:1483-1486); BASELINE workload #5 for the
    VI estimator family.
    """
    opt, step, run_chunk, eval_elbo = _fit_compiled(
        vb, learning_rate=learning_rate, grad_samples=grad_samples,
        chunk=chunk, elbo_samples=elbo_samples, rsqrt_decay=rsqrt_decay)
    vparams = vb.init
    if mesh is not None:
        from ..parallel.mesh import replicate

        vparams = replicate(mesh, vparams)
    state = opt.init(vparams)

    best = -np.inf
    best_v = vparams
    since = 0
    history = []
    it = 0
    stride = max(chunk, 1)
    check_every = max(1, -(-elbo_every // stride))  # chunks per ELBO check
    n_outer = -(-steps // stride)
    # common random numbers for the convergence checks: one fixed
    # evaluation key makes successive ELBO estimates comparable (with
    # independent keys, a +1-sigma noise spike becomes an unbeatable
    # "best" and patience fires ~2 nats before the true optimum)
    key, eval_key = jax.random.split(key)
    for outer in range(n_outer):
        key, sub = jax.random.split(key)
        if chunk > 1:
            vparams, state, val = run_chunk(vparams, state, sub)
        else:
            vparams, state, val = step(vparams, state, sub)
        it = (outer + 1) * stride
        if (outer + 1) % check_every == 0:
            e = float(eval_elbo(vparams, eval_key))
            history.append(e)
            if log_every:
                print(f"iter {it} elbo {e:.4f}")
            if e > best + tol:
                best, best_v, since = e, vparams, 0
            else:
                since += 1
                if since >= patience:
                    break
    # materialize before returning: with no ELBO checks the whole fit is
    # async-dispatched and a caller's wall-clock would otherwise stop
    # before the device work ran
    jax.block_until_ready(best_v if history else vparams)
    if not history:
        # no periodic ELBO check ran (steps < elbo_every): report the
        # final state with one multi-sample evaluation instead of -inf
        best_v = vparams
        best = float(eval_elbo(vparams, eval_key))
    return VBResult(best_v, best, it, history)
