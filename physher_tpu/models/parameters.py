"""Parameter pytrees and constraint transforms — the model-graph core, JAX-style.

The reference centers on a mutable ``Parameter``/``Model`` listener graph with
dirty-flag propagation (reference: src/phyc/parameters.c, parameters.h:95-363).
That architecture exists to make CPU incremental recomputation cheap; under
XLA the whole likelihood is one fused jitted function, so parameters become a
plain dict pytree ``{name: jnp.ndarray}`` and "models" become pure functions
of it. What remains of L4 is declarative:

- :class:`ParamSpec` — shape/init/bounds/transform of one named parameter,
- :class:`ParamSpace` — an ordered collection with pack/unpack to a flat
  vector and bijections to unconstrained space (for gradient-based ML, HMC,
  and variational inference; mirrors src/phyc/transforms.c).

Simplex parameters use the stick-breaking transform (reference:
src/phyc/simplex.c:1-420) so a K-simplex has K-1 unconstrained entries.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter block."""

    name: str
    init: np.ndarray
    lower: float = -np.inf
    upper: float = np.inf
    # 'none' | 'log' | 'logit' | 'interval' | 'simplex' | 'fixed'
    transform: str = "none"

    @staticmethod
    def scalar(name, value, lower=-np.inf, upper=np.inf, transform=None):
        if transform is None:
            transform = _default_transform(lower, upper)
        return ParamSpec(name, np.asarray(float(value)), lower, upper, transform)

    @staticmethod
    def vector(name, values, lower=-np.inf, upper=np.inf, transform=None):
        if transform is None:
            transform = _default_transform(lower, upper)
        return ParamSpec(name, np.asarray(values, dtype=np.float64), lower,
                         upper, transform)

    @staticmethod
    def simplex(name, values):
        values = np.asarray(values, dtype=np.float64)
        values = values / values.sum()
        return ParamSpec(name, values, 0.0, 1.0, "simplex")

    @staticmethod
    def fixed(name, values):
        return ParamSpec(name, np.asarray(values, dtype=np.float64),
                         transform="fixed")

    @property
    def size(self) -> int:
        return int(np.prod(self.init.shape)) if self.init.shape else 1

    @property
    def unconstrained_size(self) -> int:
        if self.transform == "fixed":
            return 0
        if self.transform == "simplex":
            return self.size - 1
        return self.size


def _default_transform(lower, upper) -> str:
    if lower == -np.inf and upper == np.inf:
        return "none"
    if upper == np.inf and lower == 0.0:
        return "log"
    if np.isfinite(lower) and np.isfinite(upper):
        return "interval"
    return "shifted_log" if np.isfinite(lower) else "none"


# -- stick-breaking simplex (matches Stan's transform; reference uses the
#    same construction in src/phyc/simplex.c with optional Stan variant) ----


def simplex_constrain(y: jnp.ndarray) -> jnp.ndarray:
    """Unconstrained R^{K-1} -> K-simplex (stick breaking, Stan convention)."""
    K = y.shape[-1] + 1
    offsets = jnp.log(jnp.arange(K - 1, 0, -1, dtype=y.dtype))
    z = jax.nn.sigmoid(y - offsets)
    zl = jnp.concatenate([jnp.ones_like(z[..., :1]), jnp.cumprod(1 - z, -1)], -1)
    x = zl[..., :-1] * z
    return jnp.concatenate([x, zl[..., -1:]], axis=-1)


def simplex_unconstrain(x: jnp.ndarray) -> jnp.ndarray:
    K = x.shape[-1]
    offsets = jnp.log(jnp.arange(K - 1, 0, -1, dtype=x.dtype))
    rem = 1.0 - jnp.concatenate(
        [jnp.zeros_like(x[..., :1]), jnp.cumsum(x[..., :-1], -1)], -1
    )[..., :-1]
    z = x[..., :-1] / jnp.maximum(rem, 1e-300)
    return jnp.log(z) - jnp.log1p(-z) + offsets


def simplex_log_jacobian(y: jnp.ndarray) -> jnp.ndarray:
    """log |det d(constrain)/dy| for the stick-breaking transform."""
    K = y.shape[-1] + 1
    offsets = jnp.log(jnp.arange(K - 1, 0, -1, dtype=y.dtype))
    t = y - offsets
    z = jax.nn.sigmoid(t)
    zl = jnp.concatenate([jnp.ones_like(z[..., :1]), jnp.cumprod(1 - z, -1)], -1)
    return jnp.sum(jnp.log(z) + jnp.log1p(-z) + jnp.log(zl[..., :-1]), -1)


class ParamSpace:
    """Ordered collection of ParamSpecs with pytree/flat/unconstrained views."""

    def __init__(self, specs: list[ParamSpec]):
        seen = {}
        for s in specs:
            if s.name in seen:
                if seen[s.name] is not s and not np.array_equal(
                    seen[s.name].init, s.init
                ):
                    raise ValueError(f"conflicting duplicate parameter {s.name}")
            seen[s.name] = s
        self.specs = list(seen.values())
        self.by_name = seen

    @property
    def names(self):
        return [s.name for s in self.specs]

    def init_params(self, dtype=None) -> dict:
        out = {}
        for s in self.specs:
            arr = jnp.asarray(s.init)
            if dtype is not None:
                arr = arr.astype(dtype)
            out[s.name] = arr
        return out

    def free_specs(self):
        return [s for s in self.specs if s.transform != "fixed"]

    @property
    def unconstrained_size(self) -> int:
        return sum(s.unconstrained_size for s in self.free_specs())

    # -- constrained <-> unconstrained pytrees ----------------------------

    def unconstrain(self, params: dict) -> dict:
        out = {}
        for s in self.free_specs():
            x = params[s.name]
            t = s.transform
            if t == "none":
                out[s.name] = x
            elif t == "log":
                out[s.name] = jnp.log(x)
            elif t == "shifted_log":
                out[s.name] = jnp.log(x - s.lower)
            elif t == "interval":
                u = (x - s.lower) / (s.upper - s.lower)
                out[s.name] = jnp.log(u) - jnp.log1p(-u)
            elif t == "simplex":
                out[s.name] = simplex_unconstrain(x)
            else:
                raise ValueError(t)
        return out

    def constrain(self, uparams: dict, params: Optional[dict] = None) -> dict:
        out = dict(params) if params else {}
        for s in self.specs:
            if s.transform == "fixed":
                out.setdefault(s.name, jnp.asarray(s.init))
        for s in self.free_specs():
            y = uparams[s.name]
            t = s.transform
            if t == "none":
                out[s.name] = y
            elif t == "log":
                out[s.name] = jnp.exp(y)
            elif t == "shifted_log":
                out[s.name] = jnp.exp(y) + s.lower
            elif t == "interval":
                out[s.name] = s.lower + (s.upper - s.lower) * jax.nn.sigmoid(y)
            elif t == "simplex":
                out[s.name] = simplex_constrain(y)
            else:
                raise ValueError(t)
        return out

    def log_jacobian(self, uparams: dict) -> jnp.ndarray:
        """log |det| of constrain(), summed over all free parameters."""
        total = 0.0
        for s in self.free_specs():
            y = uparams[s.name]
            t = s.transform
            if t == "none":
                continue
            elif t in ("log", "shifted_log"):
                total = total + jnp.sum(y)
            elif t == "interval":
                total = total + jnp.sum(
                    math.log(s.upper - s.lower)
                    + jax.nn.log_sigmoid(y) + jax.nn.log_sigmoid(-y)
                )
            elif t == "simplex":
                total = total + jnp.sum(simplex_log_jacobian(y))
        return total

    # -- flat vector view (for L-BFGS / Laplace / fullrank VI) ------------

    def unconstrained_slices(self) -> dict:
        """{spec name: (offset, size)} into the flat unconstrained vector."""
        out = {}
        i = 0
        for s in self.free_specs():
            out[s.name] = (i, s.unconstrained_size)
            i += s.unconstrained_size
        return out

    def flatten_unconstrained(self, uparams: dict) -> jnp.ndarray:
        parts = [jnp.ravel(uparams[s.name]) for s in self.free_specs()]
        return jnp.concatenate(parts) if parts else jnp.zeros((0,))

    def unflatten_unconstrained(self, vec: jnp.ndarray) -> dict:
        out = {}
        i = 0
        for s in self.free_specs():
            n = s.unconstrained_size
            shape = s.init.shape if s.transform != "simplex" else (n,)
            out[s.name] = vec[i : i + n].reshape(shape)
            i += n
        return out

    def merge(self, *others: "ParamSpace") -> "ParamSpace":
        specs = list(self.specs)
        for o in others:
            specs.extend(o.specs)
        return ParamSpace(specs)
