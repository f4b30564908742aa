"""Codon + protein model validation.

WAG is pinned against the reference oracle. Codon models (GY94/MG94) cannot
be built through the reference's JSON factory (src/phyc/substmodel.c:1527-1536
leaves the GY94/MG94 branches empty) and its raw C wiring segfaults on this
data, so they are validated against an independent numpy/scipy implementation
(scipy expm + recursive pruning written separately from the engine) plus
structural identities.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from physher_tpu.data.gcode import (
    CODON_TRIPLETS, GENETIC_CODES, sense_codon_indices,
)
from physher_tpu.data.sitepattern import SitePattern
from physher_tpu.models.codon import GY94, MG94, codon_pair_classes
from physher_tpu.models.protein import WAG, LG, Dayhoff
from physher_tpu.models.treelikelihood import TreeLikelihood
from physher_tpu.io.treeio import read_newick

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "data", "goldens")


def test_wag_golden(data_dir):
    from physher_tpu.config.builder import build_config

    cfg = json.load(open(os.path.join(GOLDEN_DIR, "wag.json")))
    ctx, _ = build_config(cfg, base_dir=data_dir)
    tlk = ctx.objects["treelikelihood"]
    p = tlk.param_space().init_params()
    logp = float(jax.jit(tlk.log_likelihood)(p))
    np.testing.assert_allclose(logp, -1297.2958256864874, rtol=0, atol=1e-8)


@pytest.mark.parametrize("maker", [WAG, LG, Dayhoff])
def test_protein_q_properties(maker):
    sm = maker()
    p = sm.param_space().init_params()
    Q = np.asarray(sm.q(p))
    pi = np.asarray(sm.frequencies(p))
    np.testing.assert_allclose(Q.sum(1), 0.0, atol=1e-12)
    np.testing.assert_allclose(-np.sum(pi * np.diag(Q)), 1.0, rtol=1e-12)
    # detailed balance
    np.testing.assert_allclose(pi[:, None] * Q, (pi[:, None] * Q).T,
                               atol=1e-12)


@pytest.mark.parametrize("maker,kw", [
    (GY94, dict()), (MG94, dict()),
])
def test_codon_q_properties(maker, kw):
    sm = maker(**kw)
    p = sm.param_space().init_params()
    p[sm.key("kappa")] = jnp.asarray(2.0)
    if sm.name == "gy94":
        p[sm.key("omega")] = jnp.asarray(0.2)
    else:
        p[sm.key("alpha")] = jnp.asarray(1.0)
        p[sm.key("beta")] = jnp.asarray(0.2)
    Q = np.asarray(sm.q(p))
    pi = np.asarray(sm.frequencies(p))
    assert Q.shape == (61, 61)
    np.testing.assert_allclose(Q.sum(1), 0.0, atol=1e-10)
    np.testing.assert_allclose(-np.sum(pi * np.diag(Q)), 1.0, rtol=1e-10)
    np.testing.assert_allclose(pi[:, None] * Q, (pi[:, None] * Q).T,
                               atol=1e-12)
    # P(t) rows sum to 1
    P = np.asarray(sm.p_t(p, jnp.asarray([0.1, 1.0])))
    np.testing.assert_allclose(P.sum(-1), 1.0, atol=1e-9)
    assert (P >= -1e-12).all()


def test_mg94_equals_gy94():
    """MG94(alpha=1, beta=omega, kappa) == GY94(kappa, omega)."""
    gy = GY94()
    mg = MG94()
    pg = gy.param_space().init_params()
    pm = mg.param_space().init_params()
    pg[gy.key("kappa")] = jnp.asarray(3.0)
    pg[gy.key("omega")] = jnp.asarray(0.15)
    pm[mg.key("kappa")] = jnp.asarray(3.0)
    pm[mg.key("alpha")] = jnp.asarray(1.0)
    pm[mg.key("beta")] = jnp.asarray(0.15)
    np.testing.assert_allclose(np.asarray(gy.q(pg)), np.asarray(mg.q(pm)),
                               atol=1e-14)


def test_codon_class_counts():
    cls = codon_pair_classes(0)
    # symmetric classification; single-nt neighbor counts match the genetic
    # code structure (each codon has at most 9 single-nt neighbors)
    assert (cls == cls.T).all()
    neighbors = (cls > 0).sum(1)
    assert neighbors.max() <= 9
    assert neighbors.min() >= 3


def _independent_codon_loglik(tree_newick, seqs, kappa, omega):
    """Recursive pruning with scipy expm — fully independent of the engine."""
    topo, dist = read_newick(tree_newick)
    sm = GY94()
    p = sm.param_space().init_params()
    p[sm.key("kappa")] = jnp.asarray(kappa)
    p[sm.key("omega")] = jnp.asarray(omega)
    Q = np.asarray(sm.q(p), dtype=np.float64)
    pi = np.asarray(sm.frequencies(p))

    sp = SitePattern.from_alignment(seqs, "codon")
    order = [sp.taxa.index(t) for t in topo.taxa]
    tp = sp.tip_partials()[order]  # [T, S, P]

    def partial(node):
        if node < topo.T:
            return tp[node]
        k = node - topo.T
        out = np.ones_like(tp[0])
        for j in range(topo.child_count[k]):
            c = int(topo.children[k, j])
            P = scipy.linalg.expm(Q * dist[c])
            out = out * (P @ partial(c))
        return out

    root = partial(topo.root)
    site_lik = pi @ root
    return float(np.sum(sp.weights * np.log(site_lik))), topo, dist, sp


def test_codon_likelihood_vs_independent():
    rng = np.random.default_rng(3)
    taxa = ["a", "b", "c", "d", "e"]
    tree = "(((a:0.1,b:0.2):0.05,c:0.3):0.1,(d:0.15,e:0.25):0.2);"
    sense = sense_codon_indices(0)
    L = 60  # codons
    seqs = {}
    anc = rng.integers(0, 61, L)
    for t in taxa:
        s = anc.copy()
        mut = rng.random(L) < 0.3
        s[mut] = rng.integers(0, 61, mut.sum())
        seqs[t] = "".join(CODON_TRIPLETS[sense[i]] for i in s)

    expected, topo, dist, sp = _independent_codon_loglik(tree, seqs, 2.0, 0.2)

    sm = GY94()
    tlk = TreeLikelihood(sp, topo, sm,
                         distances_init=np.nan_to_num(dist[: topo.N - 1]))
    p = tlk.param_space().init_params()
    p[sm.key("kappa")] = jnp.asarray(2.0)
    p[sm.key("omega")] = jnp.asarray(0.2)
    got = float(jax.jit(tlk.log_likelihood)(p))
    np.testing.assert_allclose(got, expected, rtol=1e-10)


def test_codon_reference_goldens(data_dir):
    """Parity with the reference libphyc on a committed codon fixture.

    Golden logPs minted by tools/reforacle_codon.c (the reference's JSON
    factory cannot build codon models, substmodel.c:1527-1536, so the oracle
    wires GY94/MG94 through the raw C API like phycpp does). Values in
    tests/data/goldens/codon_small.txt.
    """
    import os
    import re

    from physher_tpu.io.seqio import read_alignment
    from physher_tpu.models.treelikelihood import TreeLikelihood

    golden = open(os.path.join(data_dir, "goldens", "codon_small.txt")).read()
    gy_logp = float(re.search(r"gy94 .* logP (\S+)", golden).group(1))
    mg_logp = float(re.search(r"mg94 .* logP (\S+)", golden).group(1))

    seqs = read_alignment(os.path.join(data_dir, "codon_small.fa"))
    topo, dist = read_newick(
        open(os.path.join(data_dir, "codon_small.nwk")).read().strip())
    sp = SitePattern.from_alignment(seqs, "codon")

    gy = GY94(fixed_freqs=True)
    tlk = TreeLikelihood(sp, topo, gy, distances_init=dist)
    p = tlk.param_space().init_params()
    p[gy.key("kappa")] = jnp.asarray(2.5)
    p[gy.key("omega")] = jnp.asarray(0.3)
    np.testing.assert_allclose(float(tlk.log_likelihood(p)), gy_logp,
                               rtol=5e-9, atol=1e-7)

    mg = MG94(fixed_freqs=True)
    tlk2 = TreeLikelihood(sp, topo, mg, distances_init=dist)
    p2 = tlk2.param_space().init_params()
    p2[mg.key("alpha")] = jnp.asarray(1.0)
    p2[mg.key("beta")] = jnp.asarray(0.4)
    p2[mg.key("kappa")] = jnp.asarray(2.0)
    np.testing.assert_allclose(float(tlk2.log_likelihood(p2)), mg_logp,
                               rtol=5e-9, atol=1e-7)


def test_codon_m0_ml_recovers_omega():
    """BASELINE workload #3: codon (M0-style) likelihood + ML
    optimization. Simulate under GY94 (kappa=2, omega=0.2) via the
    simultron path (reference: src/phyc/physim.c) and recover the
    selection parameters by full-gradient Adam (the batched replacement for
    the reference's serial-Brent codon optimization,
    treelikelihoodCodon.c + optimizer.c)."""
    import jax
    import jax.numpy as jnp

    from physher_tpu.inference import ml
    from physher_tpu.likelihood.analysis import simulate_alignment
    from physher_tpu.models.codon import GY94
    from physher_tpu.models.sitemodel import ConstantSiteModel
    from physher_tpu.models.treelikelihood import TreeLikelihood
    from physher_tpu.utils.synthetic import balanced_topology

    topo = balanced_topology(8)
    subst = GY94(fixed_freqs=True)
    sim_params = {
        s.name: jnp.asarray({"kappa": 2.0, "omega": 0.2}.get(
            s.name.split(".")[-1], s.init))
        for s in subst.param_specs()}
    bl = np.full(topo.N, 0.3)
    bl[topo.root] = 0.0
    seqs = simulate_alignment(jax.random.PRNGKey(0), topo, subst,
                              ConstantSiteModel(), sim_params, bl, 1200,
                              datatype="codon")
    sp = SitePattern.from_alignment(seqs, datatype="codon")
    tlk = TreeLikelihood(sp, topo, GY94(fixed_freqs=True),
                         distances_init=np.full(topo.N - 1, 0.3))
    space = tlk.param_space()
    res = ml.optimize(tlk.log_likelihood, space, space.init_params(),
                      method="adam", max_iter=600, learning_rate=0.05)
    assert np.isfinite(res.logp)
    assert abs(float(res.params["omega"]) - 0.2) < 0.05
    assert abs(float(res.params["kappa"]) - 2.0) < 0.5
