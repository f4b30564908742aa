"""Stateful binding API mirroring the reference's C++ wrapper surface.

Rebuild of phycpp (reference: src/phycpp/physher.hpp:21-465 — the
``*Interface`` classes torchtree binds against: SetParameters /
GetParameters / LogLikelihood / RequestGradient / Gradient over flat double
buffers). The functional JAX models stay pure underneath; each Interface
object carries the current parameter values and a lazily-jitted
value-and-grad of the assembled model, so external frameworks (torchtree
etc.) get the same imperative contract the reference exposes, backed by
compiled XLA code instead of hand-written C gradients.
"""

from __future__ import annotations

import enum

import numpy as np

from .data.sitepattern import SitePattern
from .io.treeio import read_newick
from .models.clock import DiscreteClock, StrictClock
from .models.coalescent import (ConstantCoalescent, PiecewiseLinearCoalescent,
                                SkygridCoalescent, SkyrideCoalescent)
from .models.distributions import ctmc_scale_logpdf
from .models.sitemodel import (ConstantSiteModel, GammaSiteModel,
                               InvariantSiteModel, WeibullSiteModel)
from .models.substitution import GTR, HKY, JC69, GeneralReversible
from .models.treelikelihood import TreeLikelihood
from .trees.timetree import TimeTreeData


class GradientFlags(enum.Enum):
    """reference: physher.hpp:21-25"""
    TREE_RATIO = 1
    TREE_HEIGHT = 2
    COALESCENT_THETA = 3


class TreeLikelihoodGradientFlags(enum.Enum):
    """reference: physher.hpp:27-34"""
    TREE_HEIGHT = 1
    SITE_MODEL = 2
    SUBSTITUTION_MODEL = 3
    SUBSTITUTION_MODEL_RATES = 4
    SUBSTITUTION_MODEL_FREQUENCIES = 5
    BRANCH_MODEL = 6


class ModelInterface:
    """reference: physher.hpp:79-96 ModelInterface."""

    _param_keys: list = []

    def SetParameters(self, parameters) -> None:
        raise NotImplementedError

    def GetParameters(self, parameters=None) -> np.ndarray:
        raise NotImplementedError


class _ValueHolder(ModelInterface):
    """Holds named parameter values as a flat vector."""

    def __init__(self):
        self._values = {}

    def SetParameters(self, parameters) -> None:
        vec = np.asarray(parameters, dtype=np.float64).ravel()
        i = 0
        for k in self._param_keys:
            n = np.size(self._values[k])
            chunk = vec[i: i + n]
            self._values[k] = (float(chunk[0]) if n == 1
                               else np.asarray(chunk))
            i += n

    def GetParameters(self, parameters=None) -> np.ndarray:
        out = np.concatenate([np.atleast_1d(
            np.asarray(self._values[k], dtype=np.float64))
            for k in self._param_keys]) if self._param_keys else np.zeros(0)
        if parameters is not None:
            parameters[: out.size] = out
        return out


# -- tree models (physher.hpp:107-174) --------------------------------------

class TreeModelInterface(_ValueHolder):
    def __init__(self, newick: str, taxa: list | None = None):
        super().__init__()
        self.topo, self.distances = read_newick(newick)
        self.taxa = self.topo.taxa


class UnRootedTreeModelInterface(TreeModelInterface):
    """reference: physher.hpp:127-135. Parameters = branch lengths."""

    _param_keys = ["distances"]

    def __init__(self, newick: str, taxa: list | None = None):
        super().__init__(newick, taxa)
        self._values["distances"] = np.asarray(
            self.distances[: self.topo.N - 1], dtype=np.float64)
        self.time_data = None


class TimeTreeModelInterface(TreeModelInterface):
    """reference: physher.hpp:137-148. Parameters = node heights mapped to
    the ratio space internally."""

    _param_keys = ["ratios"]

    def __init__(self, newick: str, taxa: list | None = None, dates=None):
        super().__init__(newick, taxa)
        self.time_data = TimeTreeData.from_dated_tree(
            self.topo, self.distances, dates)
        I = self.topo.I
        self._values["ratios"] = np.asarray(self.time_data.ratios0[:I],
                                            dtype=np.float64)


class ReparameterizedTimeTreeModelInterface(TimeTreeModelInterface):
    """reference: physher.hpp:150-174 (ratio/height transforms +
    GradientTransformJVP)."""

    def __init__(self, newick: str, taxa: list | None = None, dates=None,
                 transform: int = 1):
        super().__init__(newick, taxa, dates)
        self.transform = transform

    def GetNodeHeights(self) -> np.ndarray:
        import jax.numpy as jnp

        from .trees.heights import heights_from_ratios

        td = self.time_data
        h = heights_from_ratios(jnp.asarray(self._values["ratios"]),
                                self.topo, td.tip_heights, td.lowers)
        return np.asarray(h)

    def GradientTransformJVP(self, height_gradient) -> np.ndarray:
        """d logL / d ratios from d logL / d heights (reference:
        treetransform.c:76-92 node_transform_jvp_backprop)."""
        import jax
        import jax.numpy as jnp

        from .trees.heights import heights_from_ratios

        td = self.time_data
        _, vjp = jax.vjp(
            lambda r: heights_from_ratios(r, self.topo, td.tip_heights,
                                          td.lowers),
            jnp.asarray(self._values["ratios"]))
        g = np.zeros(self.topo.N)
        g[self.topo.T:] = np.asarray(height_gradient)[: self.topo.I]
        return np.asarray(vjp(jnp.asarray(g))[0])

    def GradientTransformJacobian(self) -> np.ndarray:
        """Gradient of the log-det-Jacobian wrt ratios (reference:
        treetransform.c:94-120)."""
        import jax
        import jax.numpy as jnp

        from .trees.heights import heights_from_ratios, ratio_log_jacobian

        td = self.time_data

        def logjac(r):
            h = heights_from_ratios(r, self.topo, td.tip_heights, td.lowers)
            return ratio_log_jacobian(h, self.topo, td.lowers)

        return np.asarray(jax.grad(logjac)(
            jnp.asarray(self._values["ratios"])))


# -- substitution models (physher.hpp:201-267) -------------------------------

class SubstitutionModelInterface(_ValueHolder):
    def _build(self):
        raise NotImplementedError


class JC69Interface(SubstitutionModelInterface):
    _param_keys = []

    def _build(self):
        return JC69(), {}


class HKYInterface(SubstitutionModelInterface):
    _param_keys = ["kappa", "frequencies"]

    def __init__(self, kappa: float = 1.0, frequencies=None):
        super().__init__()
        self._values["kappa"] = kappa
        self._values["frequencies"] = np.asarray(
            frequencies if frequencies is not None else [0.25] * 4)

    def _build(self):
        return HKY(kappa_init=float(self._values["kappa"]),
                   freqs_init=np.asarray(self._values["frequencies"])), {}


class GTRInterface(SubstitutionModelInterface):
    _param_keys = ["rates", "frequencies"]

    def __init__(self, rates=None, frequencies=None):
        super().__init__()
        self._values["rates"] = np.asarray(
            rates if rates is not None else [1.0 / 6] * 6)
        self._values["frequencies"] = np.asarray(
            frequencies if frequencies is not None else [0.25] * 4)

    def _build(self):
        return GTR(rates_init=np.asarray(self._values["rates"]),
                   freqs_init=np.asarray(self._values["frequencies"])), {}


class GeneralSubstitutionModelInterface(SubstitutionModelInterface):
    """reference: physher.hpp:252-267 (arbitrary datatype + rate mapping)."""

    _param_keys = ["rates", "frequencies"]

    def __init__(self, state_count: int, mapping, rates, frequencies,
                 normalize: bool = True):
        super().__init__()
        self.state_count = state_count
        self.mapping = np.asarray(mapping, dtype=np.int32)
        self.normalize = normalize
        self._values["rates"] = np.asarray(rates, dtype=np.float64)
        self._values["frequencies"] = np.asarray(frequencies,
                                                 dtype=np.float64)

    def _build(self):
        return GeneralReversible(
            self.state_count, self.mapping,
            rates_init=np.asarray(self._values["rates"]),
            freqs_init=np.asarray(self._values["frequencies"]),
            normalize=self.normalize), {}


# -- site models (physher.hpp:269-358) ---------------------------------------

class SiteModelInterface(_ValueHolder):
    def _build(self):
        raise NotImplementedError


class ConstantSiteModelInterface(SiteModelInterface):
    _param_keys = ["mu"]

    def __init__(self, mu: float | None = None):
        super().__init__()
        self._values["mu"] = 1.0 if mu is None else mu
        self._use_mu = mu is not None

    def _build(self):
        return ConstantSiteModel(mu=self._use_mu,
                                 mu_init=float(self._values["mu"])), {}


class InvariantSiteModelInterface(SiteModelInterface):
    _param_keys = ["proportion"]

    def __init__(self, proportion: float = 0.1):
        super().__init__()
        self._values["proportion"] = proportion

    def _build(self):
        return InvariantSiteModel(
            pinv_init=float(self._values["proportion"])), {}


class WeibullSiteModelInterface(SiteModelInterface):
    _param_keys = ["shape"]

    def __init__(self, shape: float = 0.5, categories: int = 4,
                 invariant: float | None = None):
        super().__init__()
        self._values["shape"] = shape
        self.categories = categories
        self.invariant = invariant

    def _build(self):
        return WeibullSiteModel(
            self.categories, invariant=self.invariant is not None,
            shape_init=float(self._values["shape"]),
            pinv_init=self.invariant or 0.1), {}


class GammaSiteModelInterface(WeibullSiteModelInterface):
    def _build(self):
        return GammaSiteModel(
            self.categories, invariant=self.invariant is not None,
            shape_init=float(self._values["shape"]),
            pinv_init=self.invariant or 0.1), {}


# -- branch models (physher.hpp:176-199) -------------------------------------

class BranchModelInterface(_ValueHolder):
    pass


class StrictClockModelInterface(BranchModelInterface):
    _param_keys = ["rate"]

    def __init__(self, rate: float, tree_model: TreeModelInterface):
        super().__init__()
        self._values["rate"] = rate
        self.tree_model = tree_model

    def _build(self, N):
        return StrictClock(N, rate_init=float(self._values["rate"]))


class SimpleClockModelInterface(BranchModelInterface):
    """Per-branch rates (reference: physher.hpp:195-199)."""

    _param_keys = ["rates"]

    def __init__(self, rates, tree_model: TreeModelInterface):
        super().__init__()
        self._values["rates"] = np.asarray(rates, dtype=np.float64)
        self.tree_model = tree_model

    def _build(self, N):
        from .models.clock import RelaxedClock

        return RelaxedClock(N, prefix="clock.", rate_init=1e-3)


# -- tree likelihood (physher.hpp:360-395) -----------------------------------

class TreeLikelihoodInterface:
    """reference: physher.hpp:360-395. LogLikelihood() / RequestGradient /
    Gradient(buffer) over the assembled model."""

    def __init__(self, alignment, tree_model: TreeModelInterface,
                 substitution_model: SubstitutionModelInterface,
                 site_model: SiteModelInterface,
                 branch_model: BranchModelInterface | None = None,
                 use_ambiguities: bool = False, use_tip_states: bool = False,
                 include_jacobian: bool = False):
        if isinstance(alignment, dict):
            seqs = alignment
        else:
            seqs = dict(alignment)
        self.tree_model = tree_model
        self.substitution_model = substitution_model
        self.site_model = site_model
        self.branch_model = branch_model
        sp = SitePattern.from_alignment(seqs)
        subst, _ = substitution_model._build()
        sm, _ = site_model._build()
        clock = (branch_model._build(tree_model.topo.N)
                 if branch_model is not None else None)
        self.tlk = TreeLikelihood(
            sp, tree_model.topo, subst, sm, clock=clock,
            time_data=tree_model.time_data,
            distances_init=tree_model.distances,
            include_jacobian=include_jacobian,
            tipstates=use_tip_states,
            use_ambiguities=use_ambiguities)
        self._space = self.tlk.param_space()
        self._flags = []
        self._vg = None

    def _params(self):
        params = self._space.init_params()
        import jax.numpy as jnp

        def put(key, val):
            if key in params:
                params[key] = jnp.asarray(val, dtype=jnp.asarray(
                    params[key]).dtype)

        tm = self.tree_model
        if tm.time_data is not None:
            r = np.asarray(tm._values["ratios"], dtype=np.float64)
            put("tree.ratios", r[: self.tlk.topo.I - 1])
            put("tree.root_height", r[self.tlk.topo.I - 1])
        else:
            put("tree.distances", tm._values["distances"])
        for k in self.substitution_model._param_keys:
            put(k, self.substitution_model._values[k])
        sm = self.site_model
        for k in sm._param_keys:
            if k == "proportion":
                p = float(sm._values[k])
                put("proportions", [p, 1.0 - p])
            else:
                put(k, sm._values[k])
        if self.branch_model is not None:
            bm = self.branch_model
            for k in bm._param_keys:
                put("clock." + k if k == "rates" else k, bm._values[k])
        return params

    def LogLikelihood(self) -> float:
        import jax

        if not hasattr(self, "_fn"):
            self._fn = jax.jit(self.tlk.log_likelihood)
        return float(self._fn(self._params()))

    def RequestGradient(self, flags=None) -> None:
        """reference: physher.hpp:378-380 + TreeLikelihood_initialize_
        gradient flag logic (treelikelihood.c:180-318). With no flags every
        parameter's gradient is produced."""
        self._flags = list(flags or [])
        import jax

        self._vg = jax.jit(jax.grad(self.tlk.log_likelihood))

    def Gradient(self, gradient=None) -> np.ndarray:
        if self._vg is None:
            self.RequestGradient()
        g = self._vg(self._params())
        flags = self._flags or None
        order = []
        F = TreeLikelihoodGradientFlags
        want = {f for f in (flags or [])}

        def want_key(key):
            if not want:
                return True
            if key.startswith("tree."):
                return F.TREE_HEIGHT in want
            if key in ("shape", "pinv", "mu") or "sitemodel" in key:
                return F.SITE_MODEL in want
            if key == "rate" or key == "rates" and self.branch_model:
                return F.BRANCH_MODEL in want
            return (F.SUBSTITUTION_MODEL in want
                    or F.SUBSTITUTION_MODEL_RATES in want
                    or F.SUBSTITUTION_MODEL_FREQUENCIES in want)

        for key in g:
            if want_key(key):
                order.append(np.atleast_1d(np.asarray(g[key],
                                                      dtype=np.float64)))
        out = np.concatenate(order) if order else np.zeros(0)
        if gradient is not None:
            gradient[: out.size] = out
        return out


# -- coalescent interfaces (physher.hpp:419-465) -----------------------------

class CoalescentModelInterface:
    """reference: physher.hpp:419-441."""

    def __init__(self, coalescent, tree_model: TimeTreeModelInterface,
                 theta_key: str = "thetas"):
        self.coalescent = coalescent
        self.tree_model = tree_model
        self._theta_key = theta_key
        self._space = coalescent.param_space()

    def _heights(self):
        import jax.numpy as jnp

        from .trees.heights import heights_from_ratios

        td = self.tree_model.time_data
        return heights_from_ratios(
            jnp.asarray(self.tree_model._values["ratios"]),
            self.tree_model.topo, td.tip_heights, td.lowers)

    def LogLikelihood(self) -> float:
        params = self._space.init_params()
        return float(self.coalescent.log_prob_from_heights(
            self._heights(), params))

    def Gradient(self, gradient=None) -> np.ndarray:
        import jax

        params = self._space.init_params()
        g_theta = jax.grad(lambda p: self.coalescent.log_prob_from_heights(
            self._heights(), p))(params)
        g_h = jax.grad(lambda h: self.coalescent.log_prob_from_heights(
            h, params))(self._heights())
        parts = [np.atleast_1d(np.asarray(v)) for v in g_theta.values()]
        parts.append(np.asarray(g_h)[self.tree_model.topo.T:])
        out = np.concatenate(parts)
        if gradient is not None:
            gradient[: out.size] = out
        return out


class ConstantCoalescentModelInterface(CoalescentModelInterface):
    def __init__(self, theta: float, tree_model: TimeTreeModelInterface):
        super().__init__(
            ConstantCoalescent(tree_model.topo, theta_init=theta),
            tree_model)


class PiecewiseConstantCoalescentInterface(CoalescentModelInterface):
    """skyride (physher.hpp:446-450)."""

    def __init__(self, thetas, tree_model: TimeTreeModelInterface):
        super().__init__(
            SkyrideCoalescent(tree_model.topo,
                              thetas_init=np.asarray(thetas)), tree_model)


class PiecewiseConstantCoalescentGridInterface(CoalescentModelInterface):
    """skygrid (physher.hpp:452-457)."""

    def __init__(self, thetas, tree_model: TimeTreeModelInterface,
                 cutoff: float):
        super().__init__(
            SkygridCoalescent(tree_model.topo, len(np.asarray(thetas)),
                              cutoff, thetas_init=np.asarray(thetas)),
            tree_model)


class PiecewiseLinearCoalescentGridInterface(CoalescentModelInterface):
    def __init__(self, thetas, tree_model: TimeTreeModelInterface,
                 cutoff: float):
        super().__init__(
            PiecewiseLinearCoalescent(tree_model.topo,
                                      len(np.asarray(thetas)), cutoff,
                                      thetas_init=np.asarray(thetas)),
            tree_model)


class CTMCScaleModelInterface:
    """reference: physher.hpp:397-417."""

    def __init__(self, rates, tree_model: TimeTreeModelInterface):
        self.rates = np.asarray(rates, dtype=np.float64)
        self.tree_model = tree_model

    def _tree_length(self):
        import jax.numpy as jnp

        from .trees.heights import branch_durations, heights_from_ratios

        td = self.tree_model.time_data
        h = heights_from_ratios(
            jnp.asarray(self.tree_model._values["ratios"]),
            self.tree_model.topo, td.tip_heights, td.lowers)
        return jnp.sum(branch_durations(h, self.tree_model.topo))

    def LogLikelihood(self) -> float:
        import jax.numpy as jnp

        return float(jnp.sum(ctmc_scale_logpdf(
            jnp.asarray(self.rates), self._tree_length())))

    def Gradient(self, gradient=None) -> np.ndarray:
        import jax
        import jax.numpy as jnp

        g = jax.grad(lambda r: jnp.sum(ctmc_scale_logpdf(
            r, self._tree_length())))(jnp.asarray(self.rates))
        out = np.asarray(g)
        if gradient is not None:
            gradient[: out.size] = out
        return out
