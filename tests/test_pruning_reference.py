"""The level-array pruning engine (ops/pruning.py) against an independent
f64 NumPy Felsenstein recursion.

The reference below walks the tree recursively from the root, one node and
one pattern column at a time in vectorised NumPy, with no level schedule, no
gathers and no rescaling: partial(node) = prod_children P_child @
partial(child), logL = sum_p w_p log sum_c props_c freqs . partial_c(root).
Shapes cover balanced, caterpillar and polytomous trees, 1/3/4 rate
categories and 4/20/61 states, rescaling on and off, gradients, vmap and
vmap of jit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physher_tpu.io.treeio import read_newick
from physher_tpu.ops.pruning import pad_patterns, tree_log_likelihood

TREES = {
    "balanced": "(((A:0.1,B:0.2):0.1,(C:0.3,D:0.1):0.2):0.1,"
                "((E:0.2,F:0.1):0.3,(G:0.1,H:0.2):0.1):0.2);",
    "caterpillar": "((((((A:0.1,B:0.2):0.1,C:0.3):0.2,D:0.1):0.1,"
                   "E:0.2):0.3,F:0.1):0.1,G:0.2);",
    "polytomy": "((A:0.1,B:0.2,C:0.3):0.1,D:0.2,(E:0.1,(F:0.1,G:0.2,"
                "H:0.1,I:0.3):0.2):0.3);",
}
N_PATTERNS = 13


def numpy_log_likelihood(topo, tips, pmats, freqs, props, weights):
    """Independent f64 Felsenstein recursion (root-first, per node)."""
    tips = np.asarray(tips, np.float64)
    pmats = np.asarray(pmats, np.float64)
    C = pmats.shape[1]

    def partial(node):  # [C, S, P]
        if node < topo.T:
            return np.broadcast_to(tips[node], (C,) + tips[node].shape)
        k = node - topo.T
        out = 1.0
        for child in topo.children[k, : topo.child_count[k]]:
            lower = partial(int(child))
            out = out * np.einsum("cij,cjp->cip", pmats[child], lower)
        return out

    root = partial(topo.root)
    site = np.einsum("c,s,csp->p", np.asarray(props, np.float64),
                     np.asarray(freqs, np.float64), root)
    return float(np.sum(np.asarray(weights, np.float64) * np.log(site)))


def jc_pmats_np(bl, rates, S):
    """Jukes-Cantor-like P(t) over S states, [N, C, S, S], NumPy."""
    t = np.asarray(bl)[:, None] * np.asarray(rates)[None, :]
    e = np.exp(-S / (S - 1.0) * t)[..., None, None]
    eye = np.eye(S)
    return 1.0 / S + (eye - 1.0 / S) * e


def jc_pmats(bl, rates, S):
    t = bl[:, None] * rates[None, :]
    e = jnp.exp(-S / (S - 1.0) * t)[..., None, None]
    eye = jnp.eye(S, dtype=bl.dtype)
    return 1.0 / S + (eye - 1.0 / S) * e


def problem(shape, C, S, seed=0):
    topo, dist = read_newick(TREES[shape])
    rng = np.random.default_rng(seed)
    tips = rng.uniform(0.05, 1.0, (topo.T, S, N_PATTERNS))
    bl = np.nan_to_num(dist, nan=0.0)[: topo.N]
    rates = rng.uniform(0.3, 2.0, C)
    props = rng.dirichlet(np.ones(C))
    freqs = rng.dirichlet(np.ones(S))
    weights = rng.integers(1, 5, N_PATTERNS).astype(np.float64)
    return topo, tips, bl, rates, props, freqs, weights


def jax_logl(topo, tips, rates, props, freqs, weights, S, rescale):
    def f(bl):
        pm = jc_pmats(bl, jnp.asarray(rates), S)
        return tree_log_likelihood(
            jnp.asarray(tips), pm, topo, jnp.asarray(freqs),
            jnp.asarray(props), jnp.asarray(weights), rescale=rescale)[0]
    return f


CASES = [(shape, C, S) for shape in TREES
         for C, S in ((1, 4), (3, 20), (4, 61))]


@pytest.mark.parametrize("rescale", [False, True], ids=["plain", "rescaled"])
@pytest.mark.parametrize("shape,C,S", CASES)
def test_forward_matches_numpy(shape, C, S, rescale):
    topo, tips, bl, rates, props, freqs, weights = problem(shape, C, S)
    rng = np.random.default_rng(1)
    # general (non-JC) row-stochastic transition matrices
    pm = rng.uniform(0.01, 1.0, (topo.N, C, S, S))
    pm /= pm.sum(-1, keepdims=True)
    got, site = tree_log_likelihood(
        jnp.asarray(tips), jnp.asarray(pm), topo, jnp.asarray(freqs),
        jnp.asarray(props), jnp.asarray(weights), rescale=rescale)
    want = numpy_log_likelihood(topo, tips, pm, freqs, props, weights)
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    assert site.shape == (N_PATTERNS,)
    np.testing.assert_allclose(float(jnp.sum(jnp.asarray(weights) * site)),
                               want, rtol=1e-12)


@pytest.mark.parametrize("rescale", [False, True], ids=["plain", "rescaled"])
@pytest.mark.parametrize("shape,C,S", [("balanced", 4, 4),
                                       ("caterpillar", 3, 20),
                                       ("polytomy", 1, 4)])
def test_gradient_matches_numpy_differences(shape, C, S, rescale):
    """d logL / d branch lengths by autodiff against central differences of
    the NumPy recursion."""
    topo, tips, bl, rates, props, freqs, weights = problem(shape, C, S)
    f = jax_logl(topo, tips, rates, props, freqs, weights, S, rescale)
    g = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(bl)))

    def ref(b):
        return numpy_log_likelihood(topo, tips, jc_pmats_np(b, rates, S),
                                    freqs, props, weights)

    eps = 1e-6
    fd = np.zeros(topo.N)
    for i in range(topo.N - 1):       # the root's branch is unused
        hi, lo = bl.copy(), bl.copy()
        hi[i] += eps
        lo[i] -= eps
        fd[i] = (ref(hi) - ref(lo)) / (2 * eps)
    np.testing.assert_allclose(g[: topo.N - 1], fd[: topo.N - 1],
                               rtol=1e-6, atol=1e-7)
    assert g[topo.root] == 0.0


@pytest.mark.parametrize("wrap", ["vmap", "vmap_of_jit"])
@pytest.mark.parametrize("shape", list(TREES))
def test_batched_matches_numpy(shape, wrap):
    """A chain batch of branch-length vectors through vmap (and vmap of a
    jitted function) equals the per-member NumPy values."""
    C, S = 3, 4
    topo, tips, bl, rates, props, freqs, weights = problem(shape, C, S)
    f = jax_logl(topo, tips, rates, props, freqs, weights, S, True)
    rng = np.random.default_rng(2)
    batch = bl[None, :] * rng.uniform(0.5, 1.5, (5, topo.N))
    fn = jax.vmap(f) if wrap == "vmap" else jax.vmap(jax.jit(f))
    got = np.asarray(fn(jnp.asarray(batch)))
    want = [numpy_log_likelihood(topo, tips, jc_pmats_np(b, rates, S),
                                 freqs, props, weights) for b in batch]
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("multiple", [1, 3, 8])
def test_zero_weight_padding_is_exact(multiple):
    """Patterns padded with zero weight (shard divisibility) change
    nothing."""
    C, S = 4, 4
    topo, tips, bl, rates, props, freqs, weights = problem("balanced", C, S)
    P = pad_patterns(N_PATTERNS, multiple)
    assert P % multiple == 0 and N_PATTERNS <= P < N_PATTERNS + multiple
    tips_p = np.concatenate(
        [tips, np.ones((topo.T, S, P - N_PATTERNS))], axis=-1)
    w_p = np.concatenate([weights, np.zeros(P - N_PATTERNS)])
    f = jax_logl(topo, tips_p, rates, props, freqs, w_p, S, True)
    want = numpy_log_likelihood(topo, tips, jc_pmats_np(bl, rates, S),
                                freqs, props, weights)
    np.testing.assert_allclose(float(f(jnp.asarray(bl))), want, rtol=1e-12)


@pytest.mark.parametrize("n,multiple,want", [
    (238, 1, 238), (238, 4, 240), (238, 8, 240), (16384, 4, 16384)])
def test_pad_patterns(n, multiple, want):
    assert pad_patterns(n, multiple) == want


def test_pad_patterns_default_is_no_padding():
    assert pad_patterns(238) == 238
