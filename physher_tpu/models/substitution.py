"""Substitution models: Q construction and transition probabilities P(t).

Rebuild of the reference's substitution-model family (reference:
src/phyc/substmodel.c, jc69.c, hky.c, gtr.c, K80.c, f81.c, nucsubst.c,
unrest.c, nonstat.c, wag.c, lg.c, dayhoff.c, mg94.c, gy94.c, gensubst.c) in
JAX-idiomatic form:

- JC69 / K80 / F81 / HKY use closed-form P(t) (no eigendecomposition, exact
  autodiff; reference hky.c:230-560 computes the same analytic forms),
- general reversible models (GTR, empirical amino-acid, MG94/GY94, generic)
  symmetrize Q with sqrt(pi) and use a self-adjoint ``eigh`` — the device-friendly
  replacement for the reference's Numerical-Recipes nonsymmetric solver
  (reference: src/phyc/eigen.c:115, hessenberg.c) which only exists because
  the reference never exploits reversibility,
- non-reversible models (UNREST / NONSTAT) use scaling-and-squaring ``expm``
  on the generator, which XLA fuses into batched matmuls.

``p_t`` is vectorized over arbitrary leading batch dims of ``t`` (node x
category branch lengths), producing the ``[..., S, S]`` stack consumed by the
pruning kernels. Matrix convention matches the reference: ``P[i, j] =
P(child state j | parent state i, t)`` and partials propagate as
``P @ partial_child`` (reference: src/phyc/treelikelihood4.c:420-480).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .parameters import ParamSpec, ParamSpace


def _bt(x, t):
    """Broadcast model param x against branch-length batch t: adds trailing dims."""
    return jnp.asarray(x)[..., None]


class SubstitutionModel:
    """Base: subclasses define q(params) (normalized) and frequencies(params)."""

    name = "subst"
    state_count: int

    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def key(self, k):
        return f"{self.prefix}{k}" if self.prefix else k

    def param_space(self) -> ParamSpace:
        return ParamSpace(self.param_specs())

    def param_specs(self) -> list:
        return []

    def frequencies(self, params) -> jnp.ndarray:
        raise NotImplementedError

    def q(self, params) -> jnp.ndarray:
        """Normalized generator: -sum_i pi_i Q_ii = 1 (expected subst rate 1),
        (reference: src/phyc/substmodel.c update_Q + normalize)."""
        raise NotImplementedError

    def p_t(self, params, t: jnp.ndarray) -> jnp.ndarray:
        """Transition probabilities for branch lengths t [...]: [..., S, S]."""
        Q = self.q(params)
        if self.reversible:
            pi = self.frequencies(params)
            return p_t_reversible(Q, pi, jnp.asarray(t))
        return expm_pade(Q * jnp.asarray(t)[..., None, None])

    reversible = True

    def dp_dt(self, params, t):
        Q = self.q(params)
        return jnp.einsum("...ij,...jk->...ik", self.p_t(params, t), Q,
                          precision="highest")


def normalize_q(Q: jnp.ndarray, pi: jnp.ndarray) -> jnp.ndarray:
    mu = -jnp.einsum("...i,...ii->...", pi, Q)
    return Q / mu[..., None, None]


def _set_diagonal_neg_rowsum(Q: jnp.ndarray) -> jnp.ndarray:
    S = Q.shape[-1]
    eye = jnp.eye(S, dtype=Q.dtype)
    off = Q * (1 - eye)
    return off - eye * off.sum(-1)[..., :, None]


@jax.custom_jvp
def p_t_reversible(Q: jnp.ndarray, pi: jnp.ndarray, t: jnp.ndarray):
    """P(t) = expm(Q t) for a reversible generator, batched over t [...].

    Differentiable w.r.t. Q and t even at degenerate eigenvalues: the JVP uses
    the divided-difference (Daleckii-Krein / Frechet) formula
    ``dP = V (F o (V^-1 dQ V)) V^-1`` with ``F_ij = (e^{l_i t}-e^{l_j t}) /
    (l_i-l_j)`` and ``F_ii = t e^{l_i t}`` — the same construction the
    reference uses for dP/dparam (reference: src/phyc/substmodel.c:469-487),
    here applied as a custom JVP so autodiff through ``eigh`` (which NaNs on
    repeated eigenvalues) is avoided. ``pi`` only enables the symmetric
    decomposition; all parameter sensitivity flows through ``Q``.
    """
    lam, V, Vinv = reversible_eig(Q, pi)
    return pt_from_eig(lam, V, Vinv, t)


@p_t_reversible.defjvp
def _p_t_reversible_jvp(primals, tangents):
    Q, pi, t = primals
    dQ, _, dt = tangents
    lam, V, Vinv = reversible_eig(Q, pi)
    P = pt_from_eig(lam, V, Vinv, t)

    tb = jnp.asarray(t)[..., None]          # [..., 1]
    elt = jnp.exp(lam * tb)                 # [..., S]
    # divided differences F_ij, batched over t
    li = lam[..., :, None]
    lj = lam[..., None, :]
    ei = elt[..., :, None]
    ej = elt[..., None, :]
    diff = li - lj
    near = jnp.abs(diff) < 1e-10
    F = jnp.where(near,
                  tb[..., None] * 0.5 * (ei + ej),
                  (ei - ej) / jnp.where(near, 1.0, diff))

    hi = jax.lax.Precision.HIGHEST          # bf16 default loses ~1e-3
    M = jnp.matmul(jnp.matmul(Vinv, dQ, precision=hi), V, precision=hi)
    dP = jnp.einsum("ij,...jk,kl->...il", V, F * M, Vinv, precision=hi)
    dPdt = jnp.einsum("ij,...j,jk->...ik", V, lam * elt, Vinv,
                      precision=hi)
    dP = dP + dPdt * jnp.asarray(dt)[..., None, None]
    return P, dP


def reversible_eig(Q: jnp.ndarray, pi: jnp.ndarray):
    """Eigendecomposition of a reversible generator via symmetrization.

    S = D Q D^-1 with D = diag(sqrt pi) is symmetric; eigh(S) = (lam, W) gives
    Q = V diag(lam) V^-1 with V = D^-1 W, V^-1 = W^T D. Replaces the
    reference's general hessenberg/hqr solver for the reversible family.
    """
    sq = jnp.sqrt(pi)
    S = Q * (sq[..., :, None] / sq[..., None, :])
    S = 0.5 * (S + S.swapaxes(-1, -2))
    lam, W = jnp.linalg.eigh(S)
    # a generator's spectrum is <= 0; clamp the numerical-noise positive tail
    # (in f32 a +1e-6 eigenvalue times a large branch length explodes exp())
    lam = jnp.minimum(lam, 0.0)
    V = W / sq[..., :, None]
    Vinv = W.swapaxes(-1, -2) * sq[..., None, :]
    return lam, V, Vinv


def pt_from_eig(lam, V, Vinv, t) -> jnp.ndarray:
    """P(t) = V exp(lam t) V^-1, batched over leading dims of t
    (reference: src/phyc/substmodel.c:518-556).

    precision=highest: a lower matmul precision truncates operands (bf16 or
    TF32), and P(t) entries near t=0 are I + O(t) — the reconstruction
    cancellation amplifies that noise to ~1e-3 ABSOLUTE on off-diagonals
    that are themselves ~1e-3 (measured). These are S x S matrices; the
    extra passes are free next to the pruning dots they feed.
    """
    elt = jnp.exp(lam * t[..., None])  # [..., S]
    return jnp.einsum("...ij,...j,...jk->...ik", V, elt, Vinv,
                      precision="highest")


def expm_pade(A: jnp.ndarray, max_squarings: int = 10) -> jnp.ndarray:
    """Batched scaling-and-squaring Pade(7) matrix exponential.

    Used for non-reversible generators (UNREST/NONSTAT). The squaring count
    is norm-adaptive but static-shape: every input is scaled by
    ``2**-k`` with ``k = clip(ceil(log2(||A||_inf / 0.5)), 0, max)``
    computed per batch element in-graph, then ``max_squarings`` fixed
    squaring slots run with ``where``-masking so only ``k`` of them apply
    (XLA-friendly replacement for a data-dependent loop count; a long
    branch or unnormalized generator no longer silently degrades — cf.
    scipy.linalg.expm's ell-based scaling)."""
    S = A.shape[-1]
    dtype = A.dtype
    norm = jnp.max(jnp.sum(jnp.abs(A), axis=-1), axis=-1)  # [...]: inf-norm
    k = jnp.ceil(jnp.log2(jnp.maximum(norm, 1e-30) / 0.5))
    k = jnp.clip(k, 0.0, float(max_squarings))             # [...] per batch
    n_squarings = max_squarings
    A = A * (2.0 ** -k)[..., None, None]
    b = jnp.asarray(
        [17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0, 1.0],
        dtype=dtype,
    )
    eye = jnp.eye(S, dtype=dtype)
    hi = jax.lax.Precision.HIGHEST  # bf16 default breaks the Pade solve
    def mm(x, y):
        return jnp.matmul(x, y, precision=hi)
    A2 = mm(A, A)
    A4 = mm(A2, A2)
    A6 = mm(A4, A2)
    U = mm(A, b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
    Vm = b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye
    P = jnp.linalg.solve(Vm - U, Vm + U)
    for i in range(n_squarings):
        P = jnp.where((k > i)[..., None, None], mm(P, P), P)
    return P


# ---------------------------------------------------------------------------
# Nucleotide models
# ---------------------------------------------------------------------------


class JC69(SubstitutionModel):
    """Jukes-Cantor: equal rates/frequencies, closed-form P(t)
    (reference: src/phyc/jc69.c)."""

    name = "jc69"
    state_count = 4

    def frequencies(self, params):
        return jnp.full(4, 0.25)

    def q(self, params):
        S = 4
        Q = jnp.full((S, S), 1.0 / 3.0) - jnp.eye(S) * (1.0 / 3.0 + 1.0)
        return Q  # already normalized: -sum pi_i Q_ii = 1

    def p_t(self, params, t):
        t = jnp.asarray(t)
        e = jnp.exp(-4.0 / 3.0 * t)[..., None, None]
        eye = jnp.eye(4, dtype=e.dtype)
        return 0.25 + e * (eye - 0.25)

    def dp_dt(self, params, t):
        t = jnp.asarray(t)
        e = jnp.exp(-4.0 / 3.0 * t)[..., None, None] * (-4.0 / 3.0)
        eye = jnp.eye(4, dtype=e.dtype)
        return e * (eye - 0.25)


class K80(SubstitutionModel):
    """Kimura 1980: kappa, equal frequencies, closed form
    (reference: src/phyc/K80.c)."""

    name = "k80"
    state_count = 4

    def param_specs(self):
        return [ParamSpec.scalar(self.key("kappa"), 1.0, lower=0.0)]

    def frequencies(self, params):
        return jnp.full(4, 0.25)

    def q(self, params):
        kappa = params[self.key("kappa")]
        R = _nuc_rate_matrix(jnp.stack([
            jnp.ones_like(kappa), kappa, jnp.ones_like(kappa),
            jnp.ones_like(kappa), kappa, jnp.ones_like(kappa)]))
        Q = _set_diagonal_neg_rowsum(R * 0.25)
        return normalize_q(Q, jnp.full(4, 0.25))

    def p_t(self, params, t):
        kappa = params[self.key("kappa")]
        t = jnp.asarray(t)
        # rate normalization: mu = (kappa + 2)/4
        r = 4.0 / (kappa + 2.0)
        d = t * r
        e1 = jnp.exp(-d)                      # 4*beta*t units
        e2 = jnp.exp(-d * (kappa + 1.0) / 2.0)
        p0 = 0.25 + 0.25 * e1 + 0.5 * e2      # same state
        p1 = 0.25 + 0.25 * e1 - 0.5 * e2      # transition
        p2 = 0.25 - 0.25 * e1                 # transversion
        A, C, G, T = 0, 1, 2, 3
        P = jnp.zeros(t.shape + (4, 4), dtype=t.dtype)
        for i in range(4):
            for j in range(4):
                if i == j:
                    val = p0
                elif (i, j) in ((A, G), (G, A), (C, T), (T, C)):
                    val = p1
                else:
                    val = p2
                P = P.at[..., i, j].set(val)
        return P


def _nuc_rate_matrix(rates6: jnp.ndarray) -> jnp.ndarray:
    """Symmetric 4x4 exchangeability matrix from 6 rates (AC,AG,AT,CG,CT,GT)."""
    ac, ag, at, cg, ct, gt = (rates6[..., i] for i in range(6))
    z = jnp.zeros_like(ac)
    R = jnp.stack([
        jnp.stack([z, ac, ag, at], -1),
        jnp.stack([ac, z, cg, ct], -1),
        jnp.stack([ag, cg, z, gt], -1),
        jnp.stack([at, ct, gt, z], -1),
    ], -2)
    return R


class F81(SubstitutionModel):
    """Felsenstein 81: free frequencies, closed form (reference: src/phyc/f81.c)."""

    name = "f81"
    state_count = 4

    def __init__(self, prefix="", freqs_init=None, fixed_freqs=False):
        super().__init__(prefix)
        self.freqs_init = np.full(4, 0.25) if freqs_init is None else np.asarray(freqs_init)
        self.fixed_freqs = fixed_freqs

    def param_specs(self):
        mk = ParamSpec.fixed if self.fixed_freqs else ParamSpec.simplex
        return [mk(self.key("frequencies"), self.freqs_init)]

    def frequencies(self, params):
        return params[self.key("frequencies")]

    def q(self, params):
        pi = self.frequencies(params)
        R = 1.0 - jnp.eye(4, dtype=pi.dtype)
        Q = _set_diagonal_neg_rowsum(R * pi[None, :])
        return normalize_q(Q, pi)

    def p_t(self, params, t):
        pi = self.frequencies(params)
        t = jnp.asarray(t)
        beta = 1.0 / (1.0 - jnp.sum(pi * pi))
        e = jnp.exp(-beta * t)[..., None, None]
        eye = jnp.eye(4, dtype=pi.dtype)
        return e * eye + (1.0 - e) * pi[None, :]


class HKY(SubstitutionModel):
    """HKY85: kappa + free frequencies, fully analytic P(t)
    (reference: src/phyc/hky.c:230-560)."""

    name = "hky"
    state_count = 4

    def __init__(self, prefix="", kappa_init=1.0, freqs_init=None,
                 fixed_freqs=False, fixed_kappa=False):
        super().__init__(prefix)
        self.kappa_init = kappa_init
        self.freqs_init = np.full(4, 0.25) if freqs_init is None else np.asarray(freqs_init)
        self.fixed_freqs = fixed_freqs
        self.fixed_kappa = fixed_kappa

    def param_specs(self):
        mkf = ParamSpec.fixed if self.fixed_freqs else ParamSpec.simplex
        specs = [mkf(self.key("frequencies"), self.freqs_init)]
        if self.fixed_kappa:
            specs.append(ParamSpec.fixed(self.key("kappa"), self.kappa_init))
        else:
            specs.append(ParamSpec.scalar(self.key("kappa"), self.kappa_init,
                                          lower=0.0))
        return specs

    def frequencies(self, params):
        return params[self.key("frequencies")]

    def q(self, params):
        pi = self.frequencies(params)
        kappa = params[self.key("kappa")]
        one = jnp.ones_like(kappa)
        R = _nuc_rate_matrix(jnp.stack([one, kappa, one, one, kappa, one], -1))
        Q = _set_diagonal_neg_rowsum(R * pi[..., None, :])
        return normalize_q(Q, pi)

    def p_t(self, params, t):
        """Analytic HKY transition probabilities (Hasegawa-Kishino-Yano 1985)."""
        pi = self.frequencies(params)
        kappa = params[self.key("kappa")]
        t = jnp.asarray(t)
        A, C, G, T = (pi[..., i] for i in range(4))
        piY = C + T
        piR = A + G
        # normalization so expected rate is 1
        beta = 0.5 / (piR * piY + kappa * (A * G + C * T))
        d = beta * t

        e1 = jnp.exp(-d)
        eRA = jnp.exp(-d * (1.0 + piR * (kappa - 1.0)))  # purine eigenvalue
        eYA = jnp.exp(-d * (1.0 + piY * (kappa - 1.0)))  # pyrimidine eigenvalue

        def _hky_same(pj, pclass, e1, ec):
            return pj + pj * (1.0 - pclass) / pclass * e1 + (
                (pclass - pj) / pclass
            ) * ec

        def _hky_within(pj, pclass, e1, ec):
            return pj + pj * (1.0 - pclass) / pclass * e1 - (pj / pclass) * ec

        rows = []
        for i in range(4):
            cols = []
            for j in range(4):
                pj = pi[..., j]
                pclass = piR if j in (0, 2) else piY
                ec = eRA if j in (0, 2) else eYA
                same_class = (i in (0, 2)) == (j in (0, 2))
                if i == j:
                    cols.append(_hky_same(pj, pclass, e1, ec))
                elif same_class:
                    cols.append(_hky_within(pj, pclass, e1, ec))
                else:
                    cols.append(pj * (1.0 - e1))
            rows.append(jnp.stack(jnp.broadcast_arrays(*cols), -1))
        return jnp.stack(rows, -2)


class GTR(SubstitutionModel):
    """General time-reversible: 6 exchange rates + frequencies via eigh
    (reference: src/phyc/gtr.c; rate order AC,AG,AT,CG,CT,GT)."""

    name = "gtr"
    state_count = 4

    def __init__(self, prefix="", rates_init=None, freqs_init=None,
                 rates_simplex=False, fixed_freqs=False):
        super().__init__(prefix)
        self.rates_init = np.ones(6) if rates_init is None else np.asarray(rates_init)
        self.freqs_init = np.full(4, 0.25) if freqs_init is None else np.asarray(freqs_init)
        self.rates_simplex = rates_simplex
        self.fixed_freqs = fixed_freqs

    def param_specs(self):
        if self.rates_simplex:
            rspec = ParamSpec.simplex(self.key("rates"), self.rates_init)
        else:
            rspec = ParamSpec.vector(self.key("rates"), self.rates_init, lower=0.0)
        mkf = ParamSpec.fixed if self.fixed_freqs else ParamSpec.simplex
        return [rspec, mkf(self.key("frequencies"), self.freqs_init)]

    def frequencies(self, params):
        return params[self.key("frequencies")]

    def q(self, params):
        pi = self.frequencies(params)
        R = _nuc_rate_matrix(params[self.key("rates")])
        Q = _set_diagonal_neg_rowsum(R * pi[..., None, :])
        return normalize_q(Q, pi)


class GeneralReversible(SubstitutionModel):
    """Reversible model over an arbitrary datatype with rate-class mapping
    (reference: src/phyc/gensubst.c, nucsubst.c 5-digit codes like "01234")."""

    name = "gensubst"

    def __init__(self, state_count, mapping, prefix="", freqs_init=None,
                 rates_init=None, fixed_freqs=False, normalize=True):
        super().__init__(prefix)
        self.state_count = state_count
        mapping = np.asarray(mapping, dtype=np.int64)
        npairs = state_count * (state_count - 1) // 2
        if mapping.shape == (state_count, state_count):
            iu = np.triu_indices(state_count, 1)
            mapping = mapping[iu]
        if mapping.shape != (npairs,):
            raise ValueError("mapping must give a rate class per state pair")
        self.mapping = mapping
        self.n_classes = int(mapping.max()) + 1
        self.freqs_init = (np.full(state_count, 1.0 / state_count)
                           if freqs_init is None else np.asarray(freqs_init))
        self.rates_init = (np.ones(self.n_classes) if rates_init is None
                           else np.asarray(rates_init))
        self.fixed_freqs = fixed_freqs
        self.normalize = normalize

    def param_specs(self):
        mkf = ParamSpec.fixed if self.fixed_freqs else ParamSpec.simplex
        return [
            ParamSpec.vector(self.key("rates"), self.rates_init, lower=0.0),
            mkf(self.key("frequencies"), self.freqs_init),
        ]

    def frequencies(self, params):
        return params[self.key("frequencies")]

    def q(self, params):
        pi = self.frequencies(params)
        rates = params[self.key("rates")][self.mapping]
        S = self.state_count
        R = jnp.zeros((S, S), dtype=rates.dtype)
        iu = np.triu_indices(S, 1)
        R = R.at[iu].set(rates)
        R = R + R.T
        Q = _set_diagonal_neg_rowsum(R * pi[..., None, :])
        return normalize_q(Q, pi) if self.normalize else Q


class UNREST(SubstitutionModel):
    """Non-reversible 12-parameter nucleotide model (reference:
    src/phyc/unrest.c). P(t) via expm; frequencies are the stationary
    distribution of Q (left null vector)."""

    name = "unrest"
    state_count = 4
    reversible = False

    def __init__(self, prefix="", rates_init=None):
        super().__init__(prefix)
        self.rates_init = np.ones(12) if rates_init is None else np.asarray(rates_init)

    def param_specs(self):
        return [ParamSpec.vector(self.key("rates"), self.rates_init, lower=0.0)]

    def _q_unnorm(self, params):
        r = params[self.key("rates")]
        S = 4
        Q = jnp.zeros((S, S), dtype=r.dtype)
        idx = 0
        rows, cols = [], []
        for i in range(S):
            for j in range(S):
                if i != j:
                    rows.append(i)
                    cols.append(j)
        Q = Q.at[tuple((np.array(rows), np.array(cols)))].set(r)
        return _set_diagonal_neg_rowsum(Q)

    def frequencies(self, params):
        Q = self._q_unnorm(params)
        # stationary pi: pi Q = 0, sum pi = 1 -> solve augmented system
        S = Q.shape[-1]
        A = jnp.concatenate([Q.T, jnp.ones((1, S), dtype=Q.dtype)], axis=0)
        b = jnp.concatenate([jnp.zeros(S, dtype=Q.dtype),
                             jnp.ones(1, dtype=Q.dtype)])
        pi, *_ = jnp.linalg.lstsq(A, b)
        return pi

    def q(self, params):
        Q = self._q_unnorm(params)
        return normalize_q(Q, self.frequencies(params))


class NONSTAT(UNREST):
    """Non-reversible + free root frequencies (reference: src/phyc/nonstat.c)."""

    name = "nonstat"

    def param_specs(self):
        return super().param_specs() + [
            ParamSpec.simplex(self.key("frequencies"), np.full(4, 0.25))
        ]

    def frequencies(self, params):
        return params[self.key("frequencies")]

    def q(self, params):
        Q = self._q_unnorm(params)
        return normalize_q(Q, UNREST.frequencies(self, params))
