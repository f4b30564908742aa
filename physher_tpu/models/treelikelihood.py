"""TreeLikelihood: assembles data + tree + substitution/site/clock models into
one pure, jittable log-likelihood function of a parameter pytree.

Functional rebuild of the reference's SingleTreeLikelihood orchestrator
(reference: src/phyc/treelikelihood.c:46-124 struct, 819-832 JSON keys,
1454-1735 calculation). There is no dirty tracking: the full likelihood is
recomputed per call inside jit, which XLA fuses end-to-end; gradients come
from jax.grad (exact counterpart of the reference's O(N) analytic gradient
assembly at treelikelihood.c:2129-3100, which autodiff on the level-batched
pruning reproduces with the same asymptotic cost).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..data.sitepattern import SitePattern
from ..ops.pruning import tree_log_likelihood, pad_patterns
from ..trees.topology import Topology
from ..trees.timetree import TimeTreeData
from ..trees.heights import (
    heights_from_ratios, heights_from_shifts, shifts_from_heights,
    ratio_log_jacobian, branch_durations,
)
from .parameters import ParamSpec, ParamSpace
from .clock import BranchModel
from .sitemodel import SiteModel, ConstantSiteModel
from .substitution import SubstitutionModel


class TreeLikelihood:
    """Phylogenetic likelihood model over a fixed topology.

    Two parameterizations of branch lengths:
    - unrooted/distance mode: free branch-length vector ``{prefix}distances``
      (one per non-root node, node-id order),
    - time mode (``time_data`` given): node-height ratio parameters
      ``{prefix}ratios`` (internal postorder order) + ``{prefix}root_height``,
      with a clock model mapping durations to substitution branch lengths.
    """

    def __init__(self, site_pattern: SitePattern, topo: Topology,
                 subst_model: SubstitutionModel, site_model: SiteModel = None,
                 *, clock: BranchModel = None, time_data: TimeTreeData = None,
                 distances_init: np.ndarray = None,
                 include_jacobian: bool = False, tipstates: bool = False,
                 use_ambiguities: bool = True, rescale: bool | None = None,
                 pattern_pad_multiple: int = 1, prefix: str = "tree.",
                 dtype=None, height_transform: str = "ratio"):
        if site_model is None:
            site_model = ConstantSiteModel()
        self.sp = site_pattern
        self.topo = topo
        self.subst = subst_model
        self.site_model = site_model
        self.clock = clock
        self.time_data = time_data
        self.include_jacobian = include_jacobian
        self.prefix = prefix
        # set by parallel.mesh.shard_tree_likelihood; the pruning einsums
        # shard by GSPMD propagation from the input shardings alone
        self.mesh = None
        # RATIO / RATIO_NAIVE / PROPORTION share one transform in the
        # reference (treetransform.c new_HeightTreeTransform assigns the same
        # `update`; only the gradient algorithm differs, which autodiff
        # subsumes); SHIFT is a distinct parameterization with |J| = 1
        # (reference: src/phyc/treetransform.h:17-22)
        ht = str(height_transform or "ratio").lower()
        if ht in ("ratio", "ratio_naive", "proportion", ""):
            self.height_transform = "ratio"
        elif ht == "shift":
            self.height_transform = "shift"
        else:
            raise ValueError(f"unknown height transform {height_transform!r}")
        self.dtype = dtype or jnp.zeros(0).dtype
        if rescale is None:
            # f32 partials underflow on realistic trees; rescaling is exact
            # (the reference switches it on reactively at -inf,
            # treelikelihood.c:1497-1520; we enable it up front)
            rescale = jnp.dtype(self.dtype).itemsize < 8
        self.rescale = rescale

        if time_data is not None and clock is None:
            raise ValueError("time mode requires a clock (branch rate) model")

        # order site-pattern rows to match tip ids
        order = [site_pattern.taxa.index(t) for t in topo.taxa]
        # padding is only needed for shard divisibility (the mesh size);
        # pad columns carry zero weight, so padding is exact
        self._P = pad_patterns(site_pattern.pattern_count, pattern_pad_multiple)
        tp = site_pattern.tip_partials(
            tipstates=tipstates or not use_ambiguities, pad_to=self._P,
            dtype=np.float64)
        # host-side constants: jit embeds numpy closure constants during
        # lowering; shard_tree_likelihood device_puts these when a mesh is
        # attached (the only consumer that needs placement)
        self.tip_partials = np.asarray(tp[order], dtype=self.dtype)
        self.weights = np.asarray(
            site_pattern.padded_weights(self._P), dtype=self.dtype)

        if distances_init is None:
            distances_init = np.full(topo.N - 1, 0.1)
        self.distances_init = np.asarray(distances_init, dtype=np.float64)[
            : topo.N - 1]

    # -- parameters --------------------------------------------------------

    def key(self, k):
        return f"{self.prefix}{k}" if self.prefix else k

    def param_specs(self):
        specs = []
        if self.time_data is not None:
            td = self.time_data
            I = self.topo.I
            if self.height_transform == "shift":
                shifts0 = shifts_from_heights(td.node_heights0, self.topo)
                specs.append(ParamSpec.vector(
                    self.key("shifts"), np.maximum(shifts0, 1e-6), lower=0.0))
            else:
                specs.append(ParamSpec.vector(
                    self.key("ratios"), td.ratios0[: I - 1],
                    lower=0.0, upper=1.0))
                specs.append(ParamSpec.scalar(
                    self.key("root_height"), td.ratios0[I - 1],
                    lower=float(td.lowers[self.topo.root])))
        else:
            specs.append(ParamSpec.vector(
                self.key("distances"), self.distances_init, lower=0.0))
        specs += self.subst.param_specs()
        specs += self.site_model.param_specs()
        if self.clock is not None:
            specs += self.clock.param_specs()
        return specs

    def param_space(self) -> ParamSpace:
        return ParamSpace(self.param_specs())

    # -- computation -------------------------------------------------------

    def node_heights(self, params) -> jnp.ndarray:
        td = self.time_data
        if self.height_transform == "shift":
            return heights_from_shifts(params[self.key("shifts")], self.topo,
                                       td.tip_heights)
        ratios = jnp.concatenate([
            jnp.atleast_1d(params[self.key("ratios")]),
            jnp.atleast_1d(params[self.key("root_height")]),
        ])
        return heights_from_ratios(ratios, self.topo, td.tip_heights, td.lowers)

    def branch_lengths(self, params) -> jnp.ndarray:
        """Substitution branch length per node [N] (root entry 0)."""
        if self.time_data is not None:
            h = self.node_heights(params)
            d = branch_durations(h, self.topo)
            return d * self.clock.rates(params)
        dist = params[self.key("distances")]
        return jnp.concatenate([dist, jnp.zeros(1, dist.dtype)])

    def _run_engine(self, params):
        bl = self.branch_lengths(params)
        rates, props = self.site_model.rates_props(params)
        blc = bl[:, None] * rates[None, :]  # [N, C]
        pmats = self.subst.p_t(params, blc)  # [N, C, S, S]
        freqs = self.subst.frequencies(params)
        return tree_log_likelihood(
            self.tip_partials, pmats.astype(self.dtype), self.topo,
            freqs.astype(self.dtype), props.astype(self.dtype), self.weights,
            rescale=self.rescale)

    def log_likelihood_only(self, params) -> jnp.ndarray:
        logL, _ = self._run_engine(params)
        return logL

    def log_jacobian(self, params) -> jnp.ndarray:
        if self.height_transform == "shift":
            # |d heights / d shifts| = 1 (reference:
            # treetransform.c _node_transform_log_jacobian_zero)
            return jnp.zeros((), self.dtype)
        h = self.node_heights(params)
        return ratio_log_jacobian(h, self.topo, self.time_data.lowers)

    def log_likelihood(self, params) -> jnp.ndarray:
        logL = self.log_likelihood_only(params)
        if self.include_jacobian and self.time_data is not None:
            logL = logL + self.log_jacobian(params)
        return logL

    __call__ = log_likelihood

    def site_log_likelihoods(self, params) -> jnp.ndarray:
        _, site_log = self._run_engine(params)
        return site_log[: self.sp.pattern_count]
