"""Pruning with the topology as runtime data (for batched tree search).

The main engine (ops/pruning.py) closes over a static topology — optimal for
fixed-tree inference but requiring a recompile per topology. Tree search
(NNI/SPR) scores MANY alternative topologies; here the children arrays are
jnp inputs and the postorder is a ``lax.scan`` over internal ranks, so ONE
compiled evaluator scores a whole batch of candidate topologies via ``vmap``
(the batched answer to the reference's OpenMP-parallel move evaluation over
cloned likelihood objects, reference: src/phyc/nniopt.c:160-380,
spropt.c:1128-1380; the "fixed maximal schedule" strategy flagged in
SURVEY.md §7 hard parts).

Candidate children arrays must satisfy the postorder invariant (child rank <
parent rank) — the search layer renumbers candidates accordingly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def tree_loglik_dynamic(tip_partials, pmats, children, freqs, props,
                        weights, *, rescale: bool = False):
    """Likelihood with runtime topology.

    tip_partials: [T, S, P]; pmats: [N, C, S, S]; children: int32[I, 2]
    (binary; node ids, children before parents); returns (logL, site_log).
    """
    T, S, P = tip_partials.shape
    N, C = pmats.shape[0], pmats.shape[1]
    I = N - T
    dtype = tip_partials.dtype
    buf = jnp.zeros((N, C, S, P), dtype=dtype)
    buf = buf.at[:T].set(tip_partials[:, None, :, :])
    scal = jnp.zeros((N, P), dtype=dtype)

    def body(carry, k):
        buf, scal = carry
        l = children[k, 0]
        r = children[k, 1]
        pl = buf[l]
        pr = buf[r]
        ml = pmats[l]
        mr = pmats[r]
        res = jnp.einsum("cij,cjp->cip", ml, pl) * jnp.einsum(
            "cij,cjp->cip", mr, pr)
        if rescale:
            m = jnp.maximum(jnp.max(res, axis=(0, 1)),
                            jnp.finfo(dtype).tiny)
            res = res / m[None, None, :]
            s = scal[l] + scal[r] + jnp.log(m)
            scal = scal.at[T + k].set(s)
        buf = buf.at[T + k].set(res)
        return (buf, scal), None

    (buf, scal), _ = jax.lax.scan(body, (buf, scal), jnp.arange(I))
    root = N - 1
    site_l = jnp.einsum("s,csp->cp", freqs, buf[root])
    site_lik = jnp.einsum("c,cp->p", props, site_l)
    site_log = jnp.log(site_lik)
    if rescale:
        site_log = site_log + scal[root]
    return jnp.sum(weights * site_log), site_log


def batched_tree_loglik(tip_partials, pmats_batch, children_batch, freqs,
                        props, weights, *, rescale: bool = False):
    """vmap over candidate topologies: pmats [B, N, C, S, S],
    children [B, I, 2] -> logLs [B]."""
    fn = lambda pm, ch: tree_loglik_dynamic(  # noqa: E731
        tip_partials, pm, ch, freqs, props, weights, rescale=rescale)[0]
    return jax.vmap(fn)(pmats_batch, children_batch)


def postorder_from_children(children, T: int):
    """Valid internal-node evaluation order [I] for an ARBITRARY children
    array (no children-before-parents invariant required).

    Device-side NNI edits (``propose_nni_device``) can hang a
    higher-numbered subtree under a lower-numbered internal node, breaking
    the id-order postorder the plain scan assumes. Rather than renumbering
    subtrees (a host-side operation in TreeMCMC), compute every node's
    DEPTH from the root by pointer doubling on the parent array —
    ceil(log2 N) vectorized gather rounds, not a depth-of-tree fixed
    point — and evaluate internals deepest-first (stable argsort):
    children are strictly deeper than their parents, so every dependency
    is satisfied by construction. O(N log N) total, negligible next to
    the O(I * C * S^2 * P) likelihood itself.
    """
    I = children.shape[0]
    N = T + I
    nodes = T + jnp.arange(I, dtype=jnp.int32)
    parent = jnp.full(N, N - 1, jnp.int32)
    parent = parent.at[children[:, 0]].set(nodes)
    parent = parent.at[children[:, 1]].set(nodes)
    parent = parent.at[N - 1].set(N - 1)          # root points to itself
    dist = (jnp.arange(N) != N - 1).astype(jnp.int32)
    ptr = parent
    for _ in range(max(1, int(np.ceil(np.log2(max(N, 2)))))):
        dist = dist + dist[ptr]
        ptr = ptr[ptr]
    return jnp.argsort(-dist[T:], stable=True).astype(jnp.int32)


def tree_loglik_dynamic_ordered(tip_partials, pmats, children, order, freqs,
                                props, weights, *, rescale: bool = False):
    """``tree_loglik_dynamic`` with an explicit evaluation order [I]
    (from ``postorder_from_children``) instead of the id-order invariant —
    the evaluator for device-side topology proposals."""
    T, S, P = tip_partials.shape
    N, C = pmats.shape[0], pmats.shape[1]
    I = N - T
    dtype = tip_partials.dtype
    buf = jnp.zeros((N, C, S, P), dtype=dtype)
    buf = buf.at[:T].set(tip_partials[:, None, :, :])
    scal = jnp.zeros((N, P), dtype=dtype)

    def body(carry, r):
        buf, scal = carry
        l = children[r, 0]
        rt = children[r, 1]
        res = jnp.einsum("cij,cjp->cip", pmats[l], buf[l]) * jnp.einsum(
            "cij,cjp->cip", pmats[rt], buf[rt])
        if rescale:
            m = jnp.maximum(jnp.max(res, axis=(0, 1)),
                            jnp.finfo(dtype).tiny)
            res = res / m[None, None, :]
            scal = scal.at[T + r].set(scal[l] + scal[rt] + jnp.log(m))
        buf = buf.at[T + r].set(res)
        return (buf, scal), None

    (buf, scal), _ = jax.lax.scan(body, (buf, scal), order)
    root = N - 1
    site_l = jnp.einsum("s,csp->cp", freqs, buf[root])
    site_lik = jnp.einsum("c,cp->p", props, site_l)
    site_log = jnp.log(site_lik)
    if rescale:
        site_log = site_log + scal[root]
    return jnp.sum(weights * site_log), site_log


def parent_array(children, T: int):
    """parent[n] for every node; the root points to itself."""
    I = children.shape[0]
    N = T + I
    nodes = T + jnp.arange(I, dtype=jnp.int32)
    parent = jnp.full(N, N - 1, jnp.int32)
    parent = parent.at[children[:, 0]].set(nodes)
    parent = parent.at[children[:, 1]].set(nodes)
    return parent.at[N - 1].set(N - 1)


def tree_partials_dynamic_ordered(tip_partials, pmats, children, order, *,
                                  rescale: bool = False):
    """Full postorder sweep that RETURNS the partials/scaler state
    (buf [N, C, S, P], scal [N, P]) — the initial state for the
    incremental-recompute sampler (``update_path_partials``)."""
    T, S, P = tip_partials.shape
    N, C = pmats.shape[0], pmats.shape[1]
    dtype = tip_partials.dtype
    buf = jnp.zeros((N, C, S, P), dtype=dtype)
    buf = buf.at[:T].set(tip_partials[:, None, :, :])
    scal = jnp.zeros((N, P), dtype=dtype)

    def body(carry, r):
        buf, scal = carry
        l = children[r, 0]
        rt = children[r, 1]
        res = jnp.einsum("cij,cjp->cip", pmats[l], buf[l]) * jnp.einsum(
            "cij,cjp->cip", pmats[rt], buf[rt])
        if rescale:
            m = jnp.maximum(jnp.max(res, axis=(0, 1)),
                            jnp.finfo(dtype).tiny)
            res = res / m[None, None, :]
            scal = scal.at[T + r].set(scal[l] + scal[rt] + jnp.log(m))
        buf = buf.at[T + r].set(res)
        return (buf, scal), None

    (buf, scal), _ = jax.lax.scan(body, (buf, scal), order)
    return buf, scal


def root_loglik_from_partials(buf, scal, freqs, props, weights, *,
                              rescale: bool = False):
    """(logL, site_log) from a partials state (root = last node)."""
    root = buf.shape[0] - 1
    site_l = jnp.einsum("s,csp->cp", freqs, buf[root])
    site_log = jnp.log(jnp.einsum("c,cp->p", props, site_l))
    if rescale:
        site_log = site_log + scal[root]
    return jnp.sum(weights * site_log), site_log


def update_path_partials(buf, scal, pmats, children, start, T: int, *,
                         rescale: bool = False, parent=None):
    """Incremental recompute: refresh partials from ``start`` (a node id)
    up the root path only — the device analog of the reference's
    dirty-flag incremental recomputation + O(1) store/restore buffer
    flips (reference: src/phyc/treelikelihood.c:126-161): the old state
    stays untouched in the caller (``jnp.where`` on accept IS the
    restore), and each proposal pays O(depth) node updates instead of
    O(N).

    Runs a ``lax.while_loop`` climbing parent pointers; under vmap the
    loop executes max-path-length iterations across the batch, with
    finished chains idempotently re-computing the root (reads-only-state
    makes the extra iterations exact no-ops).
    """
    N = buf.shape[0]
    I = children.shape[0]
    dtype = buf.dtype
    if parent is None:
        parent = parent_array(children, T)

    def recompute(carry):
        buf, scal, node, done = carry
        r = node - T
        l = children[r, 0]
        rt = children[r, 1]
        res = jnp.einsum("cij,cjp->cip", pmats[l], buf[l]) * jnp.einsum(
            "cij,cjp->cip", pmats[rt], buf[rt])
        if rescale:
            m = jnp.maximum(jnp.max(res, axis=(0, 1)),
                            jnp.finfo(dtype).tiny)
            res = res / m[None, None, :]
            scal = scal.at[node].set(scal[l] + scal[rt] + jnp.log(m))
        buf = buf.at[node].set(res)
        done = node == N - 1
        node = jnp.where(done, node, parent[node])
        return buf, scal, node, done

    def cond(carry):
        return ~carry[3]

    buf, scal, _, _ = jax.lax.while_loop(
        cond, recompute, (buf, scal, start.astype(jnp.int32),
                          jnp.asarray(False)))
    return buf, scal


def propose_nni_device(key, children, T: int):
    """One uniform rooted-NNI move as pure index edits (device data).

    Picks an internal non-root node c and one of its children a, then
    swaps a with c's sibling s (the reference's NNI operator,
    src/phyc/operator.c:419-626, re-expressed as two row edits on the
    children array). Uniform over (c, child-side) pairs, whose count is
    the same for every binary topology on T taxa -> symmetric proposal,
    log q ratio = 0. Branches travel with their subtree roots (node ids
    are untouched), matching standard NNI branch semantics. The edited
    array may violate children-before-parents id order — evaluate with
    ``postorder_from_children`` + ``tree_loglik_dynamic_ordered``.

    Returns ``(children', c)`` — c is the deepest dirtied node, the
    root-path start for the incremental evaluator
    (``update_path_partials``).
    """
    I = children.shape[0]
    N = T + I
    k1, k2 = jax.random.split(key)
    parent = parent_array(children, T)

    c = jax.random.randint(k1, (), T, N - 1, dtype=jnp.int32)
    p = parent[c]
    rc = c - T
    rp = p - T
    s = jnp.where(children[rp, 0] == c, children[rp, 1], children[rp, 0])
    side = jax.random.bernoulli(k2)
    a = jnp.where(side, children[rc, 1], children[rc, 0])
    # c's row: a -> s; p's row: s -> a
    c_row = jnp.where(side,
                      jnp.stack([children[rc, 0], s]),
                      jnp.stack([s, children[rc, 1]]))
    out = children.at[rc].set(c_row)
    p_row = jnp.where(children[rp] == s, a, children[rp])
    return out.at[rp].set(p_row), c


def fitch_score_dynamic(tip_sets, children, weights):
    """Parsimony with runtime topology (for SPR prescreening, reference:
    src/phyc/spropt.c parsimony prescreen)."""
    T, P, S = tip_sets.shape
    I = children.shape[0]
    N = T + I
    sets = jnp.zeros((N, P, S), dtype=bool)
    sets = sets.at[:T].set(tip_sets)

    def body(carry, k):
        sets, score = carry
        l = children[k, 0]
        r = children[k, 1]
        sl = sets[l]
        sr = sets[r]
        inter = sl & sr
        union = sl | sr
        empty = ~inter.any(-1)
        res = jnp.where(empty[..., None], union, inter)
        sets = sets.at[T + k].set(res)
        return (sets, score + empty @ weights), None

    (sets, score), _ = jax.lax.scan(
        body, (sets, jnp.zeros((), dtype=weights.dtype)), jnp.arange(I))
    return score


def batched_fitch(tip_sets, children_batch, weights):
    return jax.vmap(lambda ch: fitch_score_dynamic(tip_sets, ch, weights))(
        children_batch)
