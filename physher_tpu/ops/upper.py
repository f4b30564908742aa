"""Upper (pre-order) partials and marginal node posteriors.

Rebuild of the reference's upper-partials machinery (reference:
src/phyc/treelikelihood.c:2129 ``update_upper_partials``, used for O(1)
per-branch evaluation, O(N) analytic gradients, and marginal ancestral
reconstruction at src/phyc/asr.c:104). The preorder sweep runs on the
topology's preorder level schedule with the same batched einsum structure as
the postorder engine.

Definition: ``upper[n]`` excludes the subtree below ``n`` and INCLUDES the
branch above ``n``... specifically here upper[n, c, s, p] is the likelihood of
all data outside n's subtree given the state at node n is s (so the node
marginal is upper ⊙ lower ⊙ nothing else, and root upper = root frequencies).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..trees.topology import Topology
from .pruning import PRECISION


def upper_partials(lower: jnp.ndarray, pmats: jnp.ndarray, topo: Topology,
                   freqs: jnp.ndarray) -> jnp.ndarray:
    """Compute upper partials [N, C, S, P] from the postorder buffer.

    lower: [N, C, S, P] postorder partials; pmats: [N, C, S, S] branch
    matrices (branch above each node).
    """
    N, C, S, P = lower.shape
    dtype = lower.dtype
    up = jnp.zeros((N, C, S, P), dtype=dtype)
    up = up.at[topo.root].set(
        jnp.broadcast_to(freqs[None, :, None], (C, S, P)))
    maxc = topo.children.shape[1]
    for ranks in topo.preorder_levels:
        # process the CHILDREN of these internal nodes
        parents = topo.T + ranks
        # sibling products: for each child j of parent k:
        #   up[child] = P_child^T @ (up[parent] * prod_{sib != child} P_sib lower[sib])
        contribs = []
        for j in range(maxc):
            ch = topo.children[ranks, j]
            mask = ch >= 0
            ch_safe = np.where(mask, ch, 0)
            pm = pmats[ch_safe]
            lo = lower[ch_safe]
            c = jnp.einsum("ncij,ncjp->ncip", pm, lo, precision=PRECISION)
            if not mask.all():
                m = jnp.asarray(mask, dtype=dtype)[:, None, None, None]
                c = c * m + (1.0 - m)
            contribs.append((ch, mask, ch_safe, c))
        parent_up = up[parents]  # [n, C, S, P]
        for j in range(maxc):
            ch, mask, ch_safe, _ = contribs[j]
            prod = parent_up
            for j2 in range(maxc):
                if j2 == j:
                    continue
                prod = prod * contribs[j2][3]
            pmj = pmats[ch_safe]
            upc = jnp.einsum("ncji,ncjp->ncip", pmj, prod)  # P^T @ prod
            if not mask.all():
                sel = np.where(mask)[0]
                up = up.at[ch_safe[sel]].set(upc[sel])
            else:
                up = up.at[ch_safe].set(upc)
    return up


def node_marginals(lower, upper, props, weights=None):
    """Posterior state probabilities per node/site: [N, S, P]
    (reference: src/phyc/asr.c marginal ASR from upper*lower)."""
    joint = jnp.einsum("c,ncsp->nsp", props, lower * upper,
                       precision=PRECISION)
    total = joint.sum(1, keepdims=True)
    return joint / total


def site_category_posteriors(lower_root, upper_root_freqs, props):
    """P(category | site): [C, P] (reference: src/phyc/ppsites.c:16-30)."""
    site_l = jnp.einsum("s,csp->cp", upper_root_freqs, lower_root,
                        precision=PRECISION)
    joint = props[:, None] * site_l
    return joint / joint.sum(0, keepdims=True)
