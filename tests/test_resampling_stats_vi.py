"""Resampling, neutrality tests, descriptive stats, and extra VI families.

Reference parity targets: src/phyc/phyresampling.c, neutralitytest.c,
statistics.c/descriptivestats.c, gamvi.c/weibullvi.c/klpq.c.
"""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physher_tpu.data.sitepattern import SitePattern
from physher_tpu.data import resampling, neutrality
from physher_tpu.utils import stats


SEQS = OrderedDict([
    ("a", "ACGTACGTAA"),
    ("b", "ACGTACGTAC"),
    ("c", "ACGAACGTAA"),
    ("d", "ACGTACCTAA"),
])


def _sp():
    return SitePattern.from_alignment(SEQS)


class TestResampling:
    def test_bootstrap_alignment_shapes(self):
        out = resampling.bootstrap_alignment(SEQS, rng=0)
        assert list(out) == list(SEQS)
        assert all(len(s) == 10 for s in out.values())
        # every column of the bootstrap is a column of the original
        orig_cols = {tuple(s[i] for s in SEQS.values()) for i in range(10)}
        boot_cols = {tuple(s[i] for s in out.values()) for i in range(10)}
        assert boot_cols <= orig_cols

    def test_jackknife_alignment(self):
        out = resampling.jackknife_alignment(SEQS, 3)
        assert all(len(s) == 9 for s in out.values())
        out2 = resampling.jackknife_alignment_n(SEQS, 4, rng=1)
        assert all(len(s) == 6 for s in out2.values())

    def test_bootstrap_weights_sum(self):
        sp = _sp()
        w = resampling.bootstrap_weights(sp, rng=0, n_replicates=5)
        assert w.shape == (5, sp.pattern_count)
        np.testing.assert_allclose(w.sum(axis=1), sp.site_count)

    def test_jackknife_weights(self):
        sp = _sp()
        w = resampling.jackknife_weights(sp, 0)
        assert w.sum() == sp.site_count - 1
        wn = resampling.jackknife_weights_n(sp, 3, rng=0)
        assert wn.sum() == sp.site_count - 3
        assert (wn >= 0).all()

    def test_reweight_likelihood_consistency(self):
        # doubling all weights doubles the log-likelihood
        from physher_tpu.models.substitution import JC69
        from physher_tpu.models.treelikelihood import TreeLikelihood
        from physher_tpu.io.treeio import read_newick
        topo, dist = read_newick("((a:0.1,b:0.2):0.05,(c:0.3,d:0.1):0.05);")
        sp = _sp()
        tlk1 = TreeLikelihood(sp, topo, JC69())
        sp2 = resampling.reweight(sp, sp.weights * 2.0)
        tlk2 = TreeLikelihood(sp2, topo, JC69())
        p = tlk1.param_space().init_params()
        l1 = float(tlk1.log_likelihood_only(p))
        l2 = float(tlk2.log_likelihood_only(p))
        assert abs(l2 - 2 * l1) < 1e-9


class TestNeutrality:
    def test_segregating_and_pi(self):
        # sites 3 (T/A), 6 (G/C), 9 (A/C) vary -> S = 3
        assert neutrality.segregating_sites(SEQS) == 3
        # pairwise diffs: ab=1 ac=1 ad=1 bc=2 bd=2 cd=2 -> mean = 9/6
        assert abs(neutrality.mean_pairwise_differences(SEQS) - 1.5) < 1e-12

    def test_watterson(self):
        a1 = 1 + 0.5 + 1 / 3
        assert abs(neutrality.watterson_theta(SEQS) - 3 / a1) < 1e-12

    def test_tajima_d_finite(self):
        d = neutrality.tajima_d(SEQS)
        assert np.isfinite(d)
        # formula check against hand computation
        n, S, pi = 4, 3.0, 1.5
        a1 = 1 + 0.5 + 1 / 3
        a2 = 1 + 0.25 + 1 / 9
        b1 = (n + 1) / (3 * (n - 1))
        b2 = 2 * (n * n + n + 3) / (9 * n * (n - 1))
        c1 = b1 - 1 / a1
        c2 = b2 - (n + 2) / (a1 * n) + a2 / a1 ** 2
        e1, e2 = c1 / a1, c2 / (a1 ** 2 + a2)
        expect = (pi - S / a1) / np.sqrt(e1 * S + e2 * S * (S - 1))
        assert abs(d - expect) < 1e-12

    def test_fu_li(self):
        assert neutrality.singleton_sites(SEQS) == 3
        assert np.isfinite(neutrality.fu_li_d_star(SEQS))
        assert np.isfinite(neutrality.fu_li_f_star(SEQS))


class TestStats:
    def test_descriptive(self):
        x = [1.0, 2.0, 3.0, 4.0]
        assert stats.mean(x) == 2.5
        assert abs(stats.variance(x) - 5 / 3) < 1e-12
        assert stats.median(x) == 2.5
        assert abs(stats.correlation(x, [2, 4, 6, 8]) - 1.0) < 1e-12
        assert abs(stats.covariance(x, x) - stats.variance(x)) < 1e-12
        assert stats.choose(6, 2) == 15

    def test_ess_iid(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=4000)
        ess = stats.effective_sample_size(x)
        assert 2500 < ess <= 4001

    def test_ess_correlated(self):
        rng = np.random.default_rng(0)
        z = rng.normal(size=4000)
        x = np.empty(4000)
        x[0] = z[0]
        for i in range(1, 4000):
            x[i] = 0.95 * x[i - 1] + z[i]
        assert stats.effective_sample_size(x) < 600

    def test_rhat(self):
        rng = np.random.default_rng(0)
        good = rng.normal(size=(4, 500))
        assert stats.split_r_hat(good) < 1.05
        bad = good + np.arange(4)[:, None] * 5.0
        assert stats.split_r_hat(bad) > 1.5

    def test_summarize(self):
        rng = np.random.default_rng(0)
        out = stats.summarize({"x": rng.normal(2.0, 1.0, size=1000)})
        assert abs(out["x"]["mean"] - 2.0) < 0.15
        assert abs(out["x"]["sd"] - 1.0) < 0.15


class TestVIFamilies:
    """Gamma / Weibull meanfield + forward-KL fit on a tractable target."""

    def _space(self):
        from physher_tpu.models.parameters import ParamSpec, ParamSpace
        spec = ParamSpec.vector("x", np.array([1.0, 1.0]), lower=0.0)
        return ParamSpace([spec])

    def test_gamma_family_recovers_gamma_target(self):
        from physher_tpu.inference.vb import GammaMeanFieldVB, fit
        from physher_tpu.models.distributions import gamma_logpdf
        space = self._space()

        def log_prob(params):
            return jnp.sum(gamma_logpdf(params["x"], 10.0, rate=5.0))

        vb = GammaMeanFieldVB(log_prob, space, {"x": jnp.ones(2) * 2.0})
        res = fit(vb, jax.random.PRNGKey(0), steps=800, learning_rate=0.05,
                  grad_samples=8, elbo_every=100)
        alpha = np.exp(np.asarray(res.vparams["log_alpha"]))
        beta = np.exp(np.asarray(res.vparams["log_beta"]))
        # q(x) should converge to Gamma(10, 5): mean 2.0
        np.testing.assert_allclose(alpha / beta, 2.0, rtol=0.1)
        np.testing.assert_allclose(alpha, 10.0, rtol=0.35)

    def test_weibull_family_moments(self):
        from physher_tpu.inference.vb import WeibullMeanFieldVB, fit
        from physher_tpu.models.distributions import lognormal_logpdf
        space = self._space()

        def log_prob(params):
            return jnp.sum(lognormal_logpdf(params["x"], 0.0, 0.3))

        vb = WeibullMeanFieldVB(log_prob, space, {"x": jnp.ones(2)})
        res = fit(vb, jax.random.PRNGKey(1), steps=800, learning_rate=0.05,
                  grad_samples=8, elbo_every=100)
        params, _ = vb.sample(res.vparams, jax.random.PRNGKey(2), 4000)
        m = float(np.mean(np.asarray(params["x"])))
        assert abs(m - np.exp(0.045)) < 0.12  # lognormal mean e^{s^2/2}

    def test_klpq_fit(self):
        from physher_tpu.inference.vb import MeanFieldNormalVB, fit_klpq
        space = self._space()

        def log_prob(params):
            # lognormal(1.0, 0.5) target on each coord
            x = params["x"]
            return jnp.sum(-0.5 * ((jnp.log(x) - 1.0) / 0.5) ** 2
                           - jnp.log(x))

        vb = MeanFieldNormalVB(log_prob, space, {"x": jnp.ones(2)})
        res = fit_klpq(vb, jax.random.PRNGKey(0), steps=600,
                       learning_rate=0.05, n_samples=64)
        loc = np.asarray(res.vparams["loc"])
        np.testing.assert_allclose(loc, 1.0, atol=0.2)

    def test_log_q_matches_samples(self):
        # integral check: entropy() equals -E[log q] under each family
        from physher_tpu.inference.vb import (GammaMeanFieldVB,
                                              WeibullMeanFieldVB)
        space = self._space()
        for cls in (GammaMeanFieldVB, WeibullMeanFieldVB):
            vb = cls(lambda p: 0.0, space, {"x": jnp.ones(2) * 1.5})
            vp = vb.init
            z = vb.sample_unconstrained(vp, jax.random.PRNGKey(0), 200000)
            mc = -float(jnp.mean(vb.log_q(vp, z)))
            assert abs(mc - float(vb.entropy(vp))) < 0.02, cls.__name__


class TestJenks:
    def test_two_clear_clusters(self):
        data = [1.0, 1.1, 0.9, 10.0, 10.2, 9.8]
        cls = stats.jenks_breaks(data, 2)
        assert len(set(cls[:3])) == 1 and len(set(cls[3:])) == 1
        assert cls[0] != cls[3]

    def test_class_count(self):
        rng = np.random.default_rng(0)
        data = np.concatenate([rng.normal(m, 0.1, 20) for m in (0, 5, 10)])
        cls = stats.jenks_breaks(data, 3)
        assert set(cls) == {0, 1, 2}
        # each true cluster maps to a single class
        for s in range(3):
            assert len(set(cls[s * 20:(s + 1) * 20])) == 1


def test_qgamma_fixed_p_matches_newton_f32():
    """Tabulated gamma quantiles (f32 fast path) track the Newton inverse."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from physher_tpu.utils.special import qgamma_fixed_p, qgamma

    p = (0.125, 0.375, 0.625, 0.875)
    pj = jnp.asarray(p)
    for a in [0.1, 0.5, 1.0, 3.7, 50.0]:
        fast = np.asarray(qgamma_fixed_p(p, jnp.asarray(a)))
        slow = np.asarray(qgamma(pj, jnp.asarray(a), jnp.asarray(a)))
        np.testing.assert_allclose(fast, slow, rtol=5e-5)
    # differentiable w.r.t. the shape
    g = jax.grad(lambda a: qgamma_fixed_p(p, a).sum())(jnp.asarray(0.7))
    gref = jax.grad(lambda a: qgamma(pj, a, a).sum())(jnp.asarray(0.7))
    np.testing.assert_allclose(np.asarray(g), np.asarray(gref), rtol=1e-3)
