"""Node-height reparameterizations for time trees (pure JAX).

Rebuild of the reference's TreeTransform (reference: src/phyc/treetransform.c).
The math is shared by the reference's RATIO / RATIO_NAIVE / PROPORTION
variants (they differ only in gradient implementation, which JAX autodiff
replaces):

    h(root)     = params[root_rank]
    h(internal) = lower(n) + (h(parent(n)) - lower(n)) * params[rank(n)]

with ``lower(n)`` = max tip height below ``n`` (reference:
src/phyc/treetransform.c:224-266 tree_transform_update_heights /
collect_lowers) and log|Jacobian| = sum over non-root internals of
log(h(parent) - lower) (reference: src/phyc/treetransform.c:214-222).

The SHIFT parameterization ``h = max(child heights) + shift`` is also
provided (reference: src/phyc/treetransform.c:14-31). Parameters are ordered
by internal postorder rank (= the reference's internal class_id,
src/phyc/tree.c:183-199), root last.

Forward transforms are parent-before-child (ratio) or child-before-parent
(shift) sweeps executed as vectorized level updates — tree-depth many scatter
steps instead of the reference's per-node recursion.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .topology import Topology


def compute_lowers(topo: Topology, tip_heights: np.ndarray) -> np.ndarray:
    """Static per-node lower bounds: max descendant tip height [N]."""
    lowers = np.zeros(topo.N)
    lowers[: topo.T] = tip_heights
    for k in range(topo.I):
        cs = topo.children[k, : topo.child_count[k]]
        lowers[topo.T + k] = lowers[cs].max()
    return lowers


# Above this internal-node count the closed-form path's [I,I] ancestor
# matrix (f32) would exceed ~16 MB; fall back to the level sweep.
_MATRIX_MAX_I = 2048


def _ratio_ancestor_mask(topo: Topology) -> np.ndarray:
    """[I-1, I-1] mask: A[k, j] = 1 iff non-root internal j is an
    ancestor-or-self of non-root internal k (static; cached on topo)."""
    A = getattr(topo, "_ratio_anc_mask", None)
    if A is None:
        I, T = topo.I, topo.T
        A = np.zeros((max(I - 1, 1), max(I - 1, 1)), dtype=np.float32)
        # postorder ranks: parent rank > child rank, so descending order
        # visits parents first and A[parent] is complete when the child needs
        # it
        for k in range(I - 2, -1, -1):
            p = int(topo.parent[T + k]) - T
            if p != I - 1:  # parent is not the root
                A[k] = A[p]
            A[k, k] = 1.0
        topo._ratio_anc_mask = A
    return A


def heights_from_ratios(params: jnp.ndarray, topo: Topology,
                        tip_heights, lowers) -> jnp.ndarray:
    """Forward ratio transform: params [I] (root height last) -> heights [N].

    For trees up to ``_MATRIX_MAX_I`` internals the recursion
    ``h(n) = l(n)(1-r(n)) + r(n) h(parent)`` is unrolled to its closed form

        h(n) = sum_a W[n,a] l(a)(1-r(a)) + R(n) H,
        W[n,a] = exp(logR(n) - logR(a)) for ancestors-or-self a,
        logR(n) = sum of log r over non-root internal ancestors-or-self,

    one masked [I,I] matvec instead of tree-depth many sequential level
    updates — the latency killer for small models on an accelerator. All W
    entries are products of ratios in (0,1], so everything stays in [0,1]
    and is exactly as stable as the sequential sweep. (Reference semantics:
    src/phyc/treetransform.c:224-266; this is an algebraic identity, not an
    approximation.)
    """
    dtype = params.dtype
    I, T = topo.I, topo.T
    tips = jnp.asarray(tip_heights, dtype=dtype)
    H = params[I - 1]
    if I == 1:
        return jnp.concatenate([tips, H[None].astype(dtype)])
    if I <= _MATRIX_MAX_I:
        A = jnp.asarray(_ratio_ancestor_mask(topo), dtype=dtype)
        lows = jnp.asarray(np.asarray(lowers)[T: T + I - 1], dtype=dtype)
        # exact-zero ratios would make logR[-inf]-logR[-inf] = nan in W;
        # the clamp is below f32 resolution of the transform output
        r = jnp.maximum(params[: I - 1], jnp.finfo(dtype).tiny)
        # precision=highest: a lower matmul precision truncates operands
        # (bf16 or TF32); logR feeds exp() so absolute matvec error becomes
        # relative height error (measured ~1e-4 heights drift at bf16)
        hi = jax.lax.Precision.HIGHEST
        logR = jnp.matmul(A, jnp.log(r), precision=hi)
        W = jnp.exp(logR[:, None] - logR[None, :]) * A
        h_int = (jnp.matmul(W, lows * (1.0 - r), precision=hi)
                 + jnp.exp(logR) * H)
        return jnp.concatenate([tips, h_int, H[None].astype(dtype)])
    h = jnp.zeros(topo.N, dtype=dtype)
    h = h.at[: topo.T].set(tips)
    lowers = jnp.asarray(lowers, dtype=dtype)
    h = h.at[topo.root].set(H)
    for ranks in topo.preorder_levels[1:]:
        nodes = topo.T + ranks
        low = lowers[nodes]
        hp = h[topo.parent[nodes]]
        h = h.at[nodes].set(low + (hp - low) * params[ranks])
    return h


def ratios_from_heights(heights: np.ndarray, topo: Topology,
                        lowers: np.ndarray) -> np.ndarray:
    """Inverse transform (host-side): heights [N] -> params [I]
    (reference: src/phyc/treetransform.c:263-266)."""
    params = np.zeros(topo.I)
    params[topo.I - 1] = heights[topo.root]
    for k in range(topo.I - 1):
        node = topo.T + k
        p = topo.parent[node]
        params[k] = (heights[node] - lowers[node]) / (heights[p] - lowers[node])
    return params


def ratio_log_jacobian(heights: jnp.ndarray, topo: Topology,
                       lowers) -> jnp.ndarray:
    """log |det dh/dratios| summed over non-root internal nodes."""
    nodes = topo.T + np.arange(topo.I - 1)
    lowers = jnp.asarray(lowers, dtype=heights.dtype)
    return jnp.sum(jnp.log(heights[topo.parent[nodes]] - lowers[nodes]))


def _shift_masks(topo: Topology):
    """Cached (anc_incl [I, I], tip_anc [T, I], desc_tip [I, T]) masks:
    internal-ancestor-or-self of internals, internal ancestors of tips, and
    descendant tips of internals."""
    cached = getattr(topo, "_shift_masks", None)
    if cached is None:
        I, T = topo.I, topo.T
        anc = np.zeros((I, I), dtype=np.float32)
        for k in range(I - 1, -1, -1):
            node = T + k
            p = int(topo.parent[node])
            if p >= 0:
                anc[k] = anc[p - T]
            anc[k, k] = 1.0
        tip_anc = np.zeros((T, I), dtype=np.float32)
        for t in range(T):
            tip_anc[t] = anc[int(topo.parent[t]) - T]
        cached = (anc, tip_anc, tip_anc.T.copy())
        topo._shift_masks = cached
    return cached


def heights_from_shifts(params: jnp.ndarray, topo: Topology,
                        tip_heights) -> jnp.ndarray:
    """SHIFT parameterization: h = max(child heights) + shift.

    Closed form (small trees): since max distributes over the +shift
    recursion, h(n) = max over descendant tips t of
    (tip_h(t) + path-sum of shifts from t up to n), i.e. with
    U(x) = sum of shifts over internal ancestors(-or-self) of x,

        h(n) = max_{t in subtree(n)} (tip_h(t) + U(t)) - U(n) + shift(n)

    — one matvec and one masked row-max (reference semantics:
    src/phyc/treetransform.c:14-31)."""
    dtype = params.dtype
    tips = jnp.asarray(tip_heights, dtype=dtype)
    I, T = topo.I, topo.T
    if I <= _MATRIX_MAX_I:
        anc, tip_anc, desc_tip = _shift_masks(topo)
        anc = jnp.asarray(anc, dtype=dtype)
        tip_anc = jnp.asarray(tip_anc, dtype=dtype)
        desc = jnp.asarray(desc_tip, dtype=dtype)
        hi = jax.lax.Precision.HIGHEST         # bf16 default drifts heights
        U = jnp.matmul(anc, params, precision=hi)        # [I]
        U_tip = jnp.matmul(tip_anc, params, precision=hi)  # [T]
        val = tips + U_tip                     # [T]
        best = jnp.max(jnp.where(desc > 0, val[None, :], -jnp.inf), axis=1)
        h_int = best - U + params
        return jnp.concatenate([tips, h_int])
    h = jnp.zeros(topo.N, dtype=dtype)
    h = h.at[: topo.T].set(tips)
    for ranks in topo.levels:
        nodes = topo.T + ranks
        hmax = None
        for j in range(topo.children.shape[1]):
            ch = topo.children[ranks, j]
            mask = ch >= 0
            vals = jnp.where(
                jnp.asarray(mask), h[np.where(mask, ch, 0)], -jnp.inf
            )
            hmax = vals if hmax is None else jnp.maximum(hmax, vals)
        h = h.at[nodes].set(hmax + params[ranks])
    return h


def shifts_from_heights(heights: np.ndarray, topo: Topology) -> np.ndarray:
    params = np.zeros(topo.I)
    for k in range(topo.I):
        cs = topo.children[k, : topo.child_count[k]]
        params[k] = heights[topo.T + k] - heights[cs].max()
    return params


def branch_durations(heights: jnp.ndarray, topo: Topology) -> jnp.ndarray:
    """Per-node time-duration of the branch above each node: [N] with 0 at
    the root. d(n) = h(parent(n)) - h(n)."""
    parent = np.where(topo.parent >= 0, topo.parent, topo.root)
    d = heights[parent] - heights
    return d.at[topo.root].set(0.0)
