"""Marginal-likelihood estimation.

Rebuild of the reference's estimators (reference: src/phyc/marginal.c:30-140
harmonic means / stepping stone / path sampling, src/phyc/is.c importance
sampling, src/phyc/bridge.c bridge sampling, src/phyc/laplace.c Laplace,
src/phyc/nest.c nested sampling, src/phyc/mmcmc.c tempered-chain driver).

The tempered ladder runs as ONE batched MCMC (temperatures on the vmapped
chain axis) instead of the reference's sequential per-temperature loop
(mmcmc.c:48-88) — the batched-ladder upgrade flagged in SURVEY.md §2.9.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .mcmc import MCMC
from ..models.parameters import ParamSpace


def log_arithmetic_mean(loglikes) -> float:
    v = jnp.asarray(loglikes)
    return float(jax.scipy.special.logsumexp(v) - jnp.log(v.shape[0]))


def log_harmonic_mean(loglikes) -> float:
    """(reference: marginal.c:33-47)"""
    v = jnp.asarray(loglikes)
    return float(jnp.log(v.shape[0]) - jax.scipy.special.logsumexp(-v))


def log_smoothed_harmonic_mean(logP, loglikes, delta=0.01) -> float:
    """One update of the stabilized harmonic mean (reference:
    marginal.c:49-64, Newton & Raftery 1994)."""
    v = jnp.asarray(loglikes)
    n = v.shape[0]
    ldelta = math.log(delta)
    l1 = math.log(1.0 - delta)
    norm = -jnp.logaddexp(ldelta, l1 + v - logP)
    num = jnp.logaddexp(
        math.log(n) + ldelta - l1 + logP,
        jax.scipy.special.logsumexp(norm + v))
    denom = jnp.logaddexp(math.log(n) + ldelta - l1,
                          jax.scipy.special.logsumexp(norm))
    return float(num - denom)


def log_stabilized_harmonic_mean(loglikes, delta=0.01, guess=None) -> float:
    """Fixed-point iteration (reference: marginal.c:66-75)."""
    logP = float(guess if guess is not None else log_harmonic_mean(loglikes))
    prev = np.inf
    for _ in range(10000):
        logP = log_smoothed_harmonic_mean(logP, loglikes, delta)
        if abs(logP - prev) < 1e-7:
            break
        prev = logP
    return logP


def log_stepping_stone(loglikes_per_temp, temperatures):
    """Stepping-stone estimator (reference: marginal.c:77-93; Xie et al 2011).

    ``loglikes_per_temp[i]`` are log-likelihood samples at temperatures[i];
    temperatures sorted INCREASING (prior 0.0 ... posterior 1.0). Returns
    (total log marginal-likelihood ratio, per-step contributions).
    """
    temps = np.asarray(temperatures)
    steps = []
    for i in range(1, len(temps)):
        dt = temps[i] - temps[i - 1]
        ll = jnp.asarray(loglikes_per_temp[i - 1])
        m = jnp.max(dt * ll)
        steps.append(float(
            m + jnp.log(jnp.mean(jnp.exp(dt * ll - m)))))
    return float(np.sum(steps)), steps


def log_path_sampling(loglikes_per_temp, temperatures):
    """Trapezoidal path sampling / thermodynamic integration (reference:
    marginal.c:95-112; Lartillot & Philippe 2006)."""
    temps = np.asarray(temperatures)
    means = np.array([float(jnp.mean(jnp.asarray(v)))
                      for v in loglikes_per_temp])
    steps = 0.5 * (means[1:] + means[:-1]) * np.diff(temps)
    return float(steps.sum()), list(steps)


def log_path_sampling_modified(loglikes_per_temp, temperatures):
    """Modified path sampling with variance correction (reference:
    marginal.c path2 variant — second-order quadrature)."""
    temps = np.asarray(temperatures)
    means = np.array([float(jnp.mean(jnp.asarray(v)))
                      for v in loglikes_per_temp])
    vars_ = np.array([float(jnp.var(jnp.asarray(v)))
                      for v in loglikes_per_temp])
    dt = np.diff(temps)
    steps = 0.5 * (means[1:] + means[:-1]) * dt - (dt ** 2) / 12.0 * (
        vars_[1:] - vars_[:-1])
    return float(steps.sum()), list(steps)


def run_tempered_ladder(key, space: ParamSpace, log_like, log_prior,
                        params, *, n_temps=16, n_iter=20000, every=10,
                        burnin=2000, distribution_power=0.3, log_ref=None,
                        mesh=None, chain_axis="chains", **mcmc_kw):
    """Run the whole temperature ladder as one batched MCMC.

    Temperatures follow the Beta(distribution_power, 1.0) quantile spacing
    the reference/BEAST use: t_i = (i/(K-1))^(1/power), increasing.
    With ``log_ref`` the ladder is the generalized-stepping-stone path
    (like*prior)^T * ref^(1-T) (reference: mmcmc.c GSS mode) and the
    recorded statistic is log(like*prior/ref). With ``mesh`` the ladder
    shards over the mesh's chain axis (n_temps must divide by it) while
    patterns ride the data axis — the multi-device form of the batched
    ladder (the reference runs its ladder sequentially, mmcmc.c:48-88).
    Returns (temperatures, loglikes [K, S], mcmc result).
    """
    i = np.arange(n_temps)
    temps = (i / (n_temps - 1)) ** (1.0 / distribution_power)
    mcmc = MCMC(space, log_like=log_like, log_prior=log_prior,
                log_ref=log_ref, **mcmc_kw)
    res = mcmc.run(key, params, n_iter=n_iter, every=every,
                   temperatures=temps, burnin=burnin,
                   mesh=mesh, chain_axis=chain_axis)
    # loglikes per temperature: [K temps] list of [S] arrays
    lls = [res.log_likelihood[:, k] for k in range(n_temps)]
    return temps, lls, res


def marginal_likelihood(key, space, log_like, log_prior, params,
                        method="stepping", **kw):
    """End-to-end GSS/SS/PS marginal likelihood (reference: mmcmc.c +
    marginal.c orchestration). method='gss' requires ``log_ref=`` (the
    working distribution); the estimate then includes the analytically-known
    log-normalizer of ref implicitly (ref must be normalized)."""
    if method == "gss" and kw.get("log_ref") is None:
        raise ValueError("gss needs log_ref")
    temps, lls, res = run_tempered_ladder(
        key, space, log_like, log_prior, params, **kw)
    if method in ("stepping", "ss", "gss"):
        val, steps = log_stepping_stone(lls, temps)
    elif method in ("path", "ps"):
        val, steps = log_path_sampling(lls, temps)
    elif method in ("path2",):
        val, steps = log_path_sampling_modified(lls, temps)
    else:
        raise ValueError(method)
    return val, {"temperatures": temps, "steps": steps, "mcmc": res}


def importance_sampling_marginal(key, vb, vparams, log_prob, n_samples=1000):
    """IS estimate of the marginal likelihood with a variational proposal
    (reference: src/phyc/is.c)."""
    draws, logq = vb.sample(vparams, key, n_samples)
    logp = jax.vmap(log_prob)(draws)
    w = logp - logq
    return float(jax.scipy.special.logsumexp(w) - jnp.log(n_samples))


def bridge_sampling_marginal(samples_u, log_unnorm, space: ParamSpace,
                             key, n_proposal=None, max_iter=1000,
                             tol=1e-10):
    """Iterative bridge sampling with a matched normal proposal
    (reference: src/phyc/bridge.c; Meng & Wong 1996).

    ``samples_u`` [S, dim] posterior draws in unconstrained space;
    ``log_unnorm(z)`` evaluates the unnormalized log-posterior (incl.
    Jacobian) at an unconstrained point.
    """
    S = samples_u.shape[0]
    n_proposal = n_proposal or S
    mu = jnp.mean(samples_u, 0)
    cov = jnp.cov(samples_u.T) + 1e-10 * jnp.eye(samples_u.shape[1])
    L = jnp.linalg.cholesky(cov)

    def logg(z):
        d = z.shape[-1]
        y = jax.scipy.linalg.solve_triangular(L, z - mu, lower=True)
        return (-0.5 * (d * math.log(2 * math.pi) + jnp.sum(y * y))
                - jnp.sum(jnp.log(jnp.diagonal(L))))

    eps = jax.random.normal(key, (n_proposal, samples_u.shape[1]),
                            dtype=samples_u.dtype)
    prop = mu + eps @ L.T

    l1 = jax.vmap(log_unnorm)(samples_u) - jax.vmap(logg)(samples_u)
    l2 = jax.vmap(log_unnorm)(prop) - jax.vmap(logg)(prop)
    s1 = S / (S + n_proposal)
    s2 = n_proposal / (S + n_proposal)

    logr = 0.0
    for _ in range(max_iter):
        num = jax.scipy.special.logsumexp(
            l2 - jnp.logaddexp(math.log(s1) + l2, math.log(s2) + logr)
        ) - math.log(n_proposal)
        den = jax.scipy.special.logsumexp(
            -jnp.logaddexp(math.log(s1) + l1, math.log(s2) + logr)
        ) - math.log(S)
        new = float(num - den)
        if abs(new - logr) < tol:
            logr = new
            break
        logr = new
    return logr


def laplace_marginal(log_prob, space: ParamSpace, map_params,
                     eps: float = 1e-4):
    """Laplace approximation at the MAP using the unconstrained-space
    Hessian (reference: src/phyc/laplace.c — the reference fits per-parameter
    gamma/lognormal/beta envelopes; the normal-on-unconstrained-space form
    here is its multivariate-normal variant)."""
    u = space.flatten_unconstrained(space.unconstrain(map_params))

    def f(z):
        up = space.unflatten_unconstrained(z)
        return log_prob(space.constrain(up)) + space.log_jacobian(up)

    # reverse-over-reverse Hessian
    H = jax.jacrev(jax.grad(f))(u)
    d = u.shape[0]
    sign, logdet = jnp.linalg.slogdet(-H)
    return float(f(u) + 0.5 * d * math.log(2 * math.pi) - 0.5 * logdet)


def laplace_marginal_fitted(log_prob, space: ParamSpace, map_params,
                            family: str = "gamma", names=None):
    """Laplace marginal likelihood with per-parameter univariate envelopes.

    Mirrors the reference's non-Gaussian Laplace variants
    (src/phyc/laplace.c:189-330 gamma, 561-700 lognormal, 81-133 beta,
    853-918 betaprime): each selected parameter gets a density q fitted so
    that its mode and curvature at the MAP match logP, and

        log Z ~= logP(MAP) - sum_i log q_i(m_i).

    The reference refines hard cases (tiny branch lengths) with a Brent
    least-squares refit over 10 probe points; here those cases use the same
    closed-form fallbacks it starts from (exponential-shape envelopes).

    ``names``: parameter names to fit (default: every free non-simplex
    spec). The curvature is the diagonal of the constrained-space Hessian,
    exactly the reference's per-Parameter ``d2logP``.
    """
    from ..models.distributions import (
        gamma_logpdf, lognormal_logpdf, beta_logpdf, betaprime_logpdf,
    )

    specs = [s for s in space.free_specs() if s.transform != "simplex"
             and (names is None or s.name in names)]
    sizes = [int(np.prod(s.init.shape)) if s.init.shape else 1 for s in specs]

    def to_vec(params):
        return jnp.concatenate([jnp.ravel(jnp.asarray(params[s.name]))
                                for s in specs])

    def f(vec):
        p = dict(map_params)
        i = 0
        for s, n in zip(specs, sizes):
            block = vec[i:i + n]
            p[s.name] = block.reshape(jnp.shape(map_params[s.name]))
            i += n
        return log_prob(p)

    m = to_vec(map_params)
    logp0 = f(m)
    d1 = jax.grad(f)(m)
    d2 = jnp.diagonal(jax.jacrev(jax.grad(f))(m))

    if family == "gamma":
        # rate = -f''(m)*m, shape = rate*m + 1 (laplace.c:189-192)
        rate = -d2 * m
        shape = rate * m + 1.0
        bad = (m < 1e-6) | (d2 >= 0)
        rate = jnp.where(bad, jnp.abs(d1), rate)
        shape = jnp.where(bad, 1.0, shape)
        corr = gamma_logpdf(m, shape=shape, rate=rate)
    elif family == "lognormal":
        # sigma = sqrt(-1/(f''(m) m^2)), mu = log m + sigma^2 (laplace.c:561)
        var = -1.0 / (d2 * m * m)
        mu = jnp.log(m) + var
        bad = (m < 1e-6) | (d2 >= 0) | (mu > 5.0)
        # gamma fallback exactly as the reference (laplace.c:584-588)
        rate = jnp.where(bad, -d2 * m, 1.0)
        shape = rate * m + 1.0
        bad2 = bad & ((m < 1e-6) | (d2 >= 0))
        rate = jnp.where(bad2, jnp.abs(d1), rate)
        shape = jnp.where(bad2, 1.0, shape)
        corr = jnp.where(
            bad, gamma_logpdf(m, shape=shape, rate=rate),
            lognormal_logpdf(m, mu=mu, sigma=jnp.sqrt(jnp.abs(var))))
    elif family == "beta":
        # mode+curvature matched Beta: mode (alpha-1)/(alpha+beta-2) = m and
        # f''(m) = -(alpha-1)/m^2 - (beta-1)/(1-m)^2 solve to the closed form
        # below. (The reference's algebra at laplace.c:81-111 matches the
        # mode but not the curvature — for an exact unnormalized Beta(3,4)
        # it returns (11,16); we implement the intended mode+curvature
        # match, which is exact in that case.)
        beta = 1.0 - d2 * m * (1.0 - m) ** 2
        alpha = 1.0 - d2 * m * m * (1.0 - m)
        corr = beta_logpdf(m, alpha=alpha, beta=beta)
    elif family == "betaprime":
        # alpha = 1 - f''(m) m^2 (m+1), beta = -f''(m) m (m+1) - 1
        # (laplace.c:853-856)
        alpha = 1.0 - d2 * m * m * (m + 1.0)
        beta = -d2 * m * (m + 1.0) - 1.0
        bad = beta < 0
        beta = jnp.where(bad, jnp.abs(d1) - 1.0, beta)
        alpha = jnp.where(bad, 1.0, alpha)
        corr = betaprime_logpdf(m, alpha=alpha, beta=beta)
    else:
        raise ValueError(f"unknown laplace family {family!r}")

    return float(logp0 - jnp.sum(corr))


def nested_sampling(key, space: ParamSpace, log_like, sample_prior,
                    *, n_live=100, max_iter=10000, tol=1e-4, mcmc_steps=20,
                    step=0.2):
    """Nested sampling with random-walk replacement within the likelihood
    shell (reference: src/phyc/nest.c:116 nest_run)."""
    key, sub = jax.random.split(key)
    live_u = sample_prior(sub, n_live)  # [n_live, dim] unconstrained
    ll = jax.vmap(lambda z: log_like(space.constrain(
        space.unflatten_unconstrained(z))))(live_u)

    @jax.jit
    def replace(key, u0, threshold, scale):
        def body(carry, k):
            u, cur = carry
            k1, k2 = jax.random.split(k)
            prop = u + scale * jax.random.normal(k1, u.shape, dtype=u.dtype)
            llp = log_like(space.constrain(
                space.unflatten_unconstrained(prop)))
            ok = llp > threshold
            return (jnp.where(ok, prop, u), jnp.where(ok, llp, cur)), None

        keys = jax.random.split(key, mcmc_steps)
        (u, cur), _ = jax.lax.scan(body, (u0, -jnp.inf), keys)
        return u, cur

    logZ = -np.inf
    logw = math.log(1.0 - math.exp(-1.0 / n_live))
    h = 0.0
    for it in range(max_iter):
        worst = int(jnp.argmin(ll))
        l_worst = float(ll[worst])
        logZ_new = np.logaddexp(logZ, logw + l_worst)
        logZ = logZ_new
        logw -= 1.0 / n_live
        # replace worst with a draw above the threshold, seeded from a
        # random surviving live point
        key, k1, k2 = jax.random.split(key, 3)
        seed_idx = int(jax.random.randint(k1, (), 0, n_live))
        u_new, ll_new = replace(k2, live_u[seed_idx], l_worst, step)
        if float(ll_new) <= l_worst:
            continue
        live_u = live_u.at[worst].set(u_new)
        ll = ll.at[worst].set(ll_new)
        # termination: remaining prior mass contributes < tol
        if logw + float(jnp.max(ll)) < logZ + math.log(tol):
            break
    # final live-point contribution
    logZ = np.logaddexp(
        logZ, float(jax.scipy.special.logsumexp(ll)) - math.log(n_live)
        + logw + math.log(n_live) - 1.0)
    return float(logZ)
