"""Maximum-likelihood / MAP optimization.

Functional replacement for the reference's optimizer stack (reference:
src/phyc/optimizer.c: meta/Brent/serial-Brent/BFGS/CG/Powell/SG/Adam). The
reference's serial-Brent-per-branch loop exists because it lacks cheap full
gradients; with autodiff the idiomatic device approach is full-vector
first-order (Adam) and quasi-Newton (L-BFGS) optimization of ALL parameters
in unconstrained space, with every iteration one fused jitted step.

``optimize`` mirrors the meta-optimizer contract (rounds until the objective
improves by < tol, reference: optimizer.c:154-210) and supports checkpointing
like the reference (reference: src/phyc/checkpoint.c, optimizer.c:870-878).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..utils.optim import adam as fast_adam

from ..models.parameters import ParamSpace


@dataclass
class OptResult:
    params: dict
    logp: float
    iterations: int
    converged: bool
    history: list = field(default_factory=list)


def _make_loss(log_prob: Callable, space: ParamSpace):
    def loss(uparams):
        return -log_prob(space.constrain(uparams))

    return loss


def _adam_machine(loss, learning_rate: float):
    """(init, step) pair with one jitted step — reusable across meta rounds
    (re-jitting per round was the dominant CPU cost on fluA-sized models)."""
    opt = fast_adam(learning_rate)

    @jax.jit
    def step(uparams, state):
        val, grads = jax.value_and_grad(loss)(uparams)
        updates, state = opt.update(grads, state, uparams)
        return optax.apply_updates(uparams, updates), state, val

    return opt.init, step


def _lbfgs_machine(loss, history_size: int = 20):
    opt = optax.lbfgs(memory_size=history_size)
    value_and_grad = optax.value_and_grad_from_state(loss)

    @jax.jit
    def step(uparams, state):
        val, grad = value_and_grad(uparams, state=state)
        updates, state = opt.update(
            grad, state, uparams, value=val, grad=grad, value_fn=loss)
        return optax.apply_updates(uparams, updates), state, val, grad

    return opt.init, step


def optimize_adam(log_prob, space: ParamSpace, params: dict, *,
                  learning_rate: float = 0.05, max_iter: int = 5000,
                  tol: float = 1e-6, patience: int = 100,
                  checkpoint: Optional[str] = None,
                  checkpoint_every: int = 1000,
                  log_every: int = 0, _machine=None) -> OptResult:
    """Adam on the unconstrained reparameterization (reference:
    src/phyc/gradascent.c optimize_stochastic_gradient_adam)."""
    uparams = space.unconstrain(params)
    if _machine is None:
        loss = _make_loss(log_prob, space)
        _machine = _adam_machine(loss, learning_rate)
    init, step = _machine
    state = init(uparams)
    best = np.inf
    best_u = uparams
    since = 0
    history = []
    it = 0
    for it in range(max_iter):
        uparams, state, val = step(uparams, state)
        v = float(val)
        history.append(-v)
        if log_every and it % log_every == 0:
            print(f"iter {it} logP {-v:.6f}")
        if v < best - tol:
            best, best_u, since = v, uparams, 0
        else:
            since += 1
            if since >= patience:
                break
        if checkpoint and it % checkpoint_every == 0 and it > 0:
            save_checkpoint(checkpoint, space.constrain(best_u))
    final = space.constrain(best_u)
    if checkpoint:
        save_checkpoint(checkpoint, final)
    return OptResult(final, -best, it + 1, since < patience, history)


def optimize_adam_adapt(log_prob, space: ParamSpace, params: dict, *,
                        etas=(1.0, 0.1, 0.01, 0.001), trial_iter: int = 100,
                        **kw) -> OptResult:
    """Learning-rate search, then a full Adam run at the winner (reference:
    src/phyc/gradascent.c:141-203 optimize_stochastic_gradient_adapt, which
    trials the etas on a pthread pool — here the trials run as ONE vmapped
    optimization over the eta batch).
    """
    uparams = space.unconstrain(params)
    loss = _make_loss(log_prob, space)
    etas_arr = jnp.asarray(list(etas))
    flat0 = space.flatten_unconstrained(uparams)

    def trial(eta):
        opt = fast_adam(1.0)  # rescale per-eta below

        def step(carry, _):
            flat, state = carry
            up = space.unflatten_unconstrained(flat)
            val, grads = jax.value_and_grad(loss)(up)
            gflat = space.flatten_unconstrained(grads)
            updates, state = opt.update(gflat, state, flat)
            return (flat + eta * updates, state), val

        (flat, _), vals = jax.lax.scan(
            step, (flat0, fast_adam(1.0).init(flat0)), None,
            length=trial_iter)
        up = space.unflatten_unconstrained(flat)
        return loss(up)

    finals = jax.jit(jax.vmap(trial))(etas_arr)
    finals = jnp.where(jnp.isfinite(finals), finals, jnp.inf)
    best_eta = float(etas_arr[int(jnp.argmin(finals))])
    return optimize_adam(log_prob, space, params, learning_rate=best_eta,
                         **kw)


def optimize_lbfgs(log_prob, space: ParamSpace, params: dict, *,
                   max_iter: int = 500, tol: float = 1e-8,
                   history_size: int = 20, _machine=None) -> OptResult:
    """L-BFGS with Zoom linesearch on the unconstrained space (replacement
    for the reference's BFGS/CG, src/phyc/bfgs.c, frpmrn.c)."""
    uparams = space.unconstrain(params)
    loss = _make_loss(log_prob, space)
    if _machine is None:
        _machine = _lbfgs_machine(loss, history_size)
    init, step = _machine
    state = init(uparams)
    prev = np.inf
    it = 0
    converged = False
    for it in range(max_iter):
        uparams, state, val, grad = step(uparams, state)
        v = float(val)
        if not np.isfinite(v):
            break
        if abs(prev - v) < tol:
            converged = True
            break
        prev = v
    final_val = float(loss(uparams))
    return OptResult(space.constrain(uparams), -final_val, it + 1, converged)


def brent_minimize(f, lo: float, hi: float, *, tol: float = 1e-8,
                   max_iter: int = 100):
    """Bounded scalar minimization: golden-section start + parabolic steps
    (reference: src/phyc/brent.c — the workhorse the meta-optimizer uses
    for per-parameter line searches)."""
    gr = 0.3819660112501051  # 2 - golden ratio
    a, b = float(lo), float(hi)
    x = w = v = a + gr * (b - a)
    fx = fw = fv = f(x)
    d = e = 0.0
    for _ in range(max_iter):
        m = 0.5 * (a + b)
        tol1 = tol * abs(x) + 1e-12
        if abs(x - m) <= 2 * tol1 - 0.5 * (b - a):
            break
        use_gold = True
        if abs(e) > tol1:
            # parabolic fit through x, w, v
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2.0 * (q - r)
            if q > 0:
                p = -p
            q = abs(q)
            if (abs(p) < abs(0.5 * q * e) and p > q * (a - x)
                    and p < q * (b - x)):
                e, d = d, p / q
                u = x + d
                if (u - a) < 2 * tol1 or (b - u) < 2 * tol1:
                    d = tol1 if x < m else -tol1
                use_gold = False
        if use_gold:
            e = (b if x < m else a) - x
            d = gr * e
        u = x + (d if abs(d) >= tol1 else (tol1 if d > 0 else -tol1))
        fu = f(u)
        if fu <= fx:
            if u >= x:
                a = x
            else:
                b = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, w = w, u
                fv, fw = fw, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x, fx


def _brent_scalar_pass(log_prob, space: ParamSpace, params: dict,
                       tol: float, fn=None) -> dict:
    """One round of bounded Brent over each *scalar* parameter with the
    rest fixed (reference: serial-Brent sub-optimizers inside meta,
    optimizer.c:100-152). Escapes coordinate-wise local basins that joint
    gradient descent falls into (e.g. extreme gamma-shape starts)."""
    import jax.numpy as jnp

    params = dict(params)
    if fn is None:
        fn = jax.jit(log_prob)
    for spec in space.free_specs():
        if spec.unconstrained_size != 1 or np.size(params[spec.name]) != 1:
            continue
        name = spec.name
        cur = float(np.asarray(params[name]))
        uspec = ParamSpace([spec])

        def f(u):
            p = uspec.constrain({name: jnp.asarray(u)})
            return -float(fn({**params, name: jnp.asarray(
                p[name], dtype=jnp.asarray(params[name]).dtype)}))

        u0 = float(np.asarray(uspec.unconstrain(
            {name: jnp.asarray(cur)})[name]))
        span = max(3.0, abs(u0))
        ub, fb = brent_minimize(f, u0 - span, u0 + span, tol=tol)
        if fb < -float(fn(params)) - tol:
            newv = uspec.constrain({name: jnp.asarray(ub)})[name]
            params[name] = jnp.asarray(
                newv, dtype=jnp.asarray(params[name]).dtype)
    return params


def _multistart_warmup(log_prob, space: ParamSpace, params: dict, *,
                       n_starts: int = 6, iters: int = 300,
                       learning_rate: float = 0.05, jitter: float = 1.5,
                       seed: int = 0) -> dict:
    """Batched Adam from jittered starts; returns the best start's params.

    The reference's meta-optimizer escapes coordinate-local basins with
    serial bounded Brent per scalar (optimizer.c:100-152); the batched
    equivalent is a *vmapped* short optimization over perturbed starts —
    one compile, the batch axis rides the accelerator. Scalar parameters
    (gamma shape, kappa, pinv...) get unconstrained-space jitter; vectors
    keep their initial values.
    """
    loss = _make_loss(log_prob, space)
    u0 = space.flatten_unconstrained(space.unconstrain(params))
    mask = np.zeros(space.unconstrained_size)
    off = 0
    for s in space.free_specs():
        if s.unconstrained_size == 1:
            mask[off] = 1.0
        off += s.unconstrained_size
    key = jax.random.PRNGKey(seed)
    eps = jax.random.normal(key, (n_starts, u0.size), dtype=u0.dtype)
    starts = u0[None, :] + jitter * jnp.asarray(mask) * eps
    starts = starts.at[0].set(u0)

    def flat_loss(u):
        return loss(space.unflatten_unconstrained(u))

    opt = fast_adam(learning_rate)

    def run_one(u):
        def step(carry, _):
            u, state = carry
            _, g = jax.value_and_grad(flat_loss)(u)
            updates, state = opt.update(g, state, u)
            return (optax.apply_updates(u, updates), state), None

        (u, _), _ = jax.lax.scan(step, (u, opt.init(u)), None, length=iters)
        return u, flat_loss(u)

    finals, losses = jax.jit(jax.vmap(run_one))(starts)
    losses = jnp.where(jnp.isfinite(losses), losses, jnp.inf)
    best = finals[int(jnp.argmin(losses))]
    return space.constrain(space.unflatten_unconstrained(best))


def optimize(log_prob, space: ParamSpace, params: dict, *,
             method: str = "meta", n_starts: int = 1, mesh=None,
             **kw) -> OptResult:
    """Meta strategy: (optional vmapped multi-start warmup), Adam, L-BFGS
    polish, then bounded-Brent scalar line searches, looping until no round
    improves by more than ``tol`` (the reference's meta-optimizer loop
    contract, optimizer.c:154-210 with serial-Brent sub-optimizers).

    ``mesh``: replicate the parameters over a device mesh so every
    optimization step runs sharded — the target's TreeLikelihood pattern
    constants carry the data-axis sharding and GSPMD places the psum at
    the weighted root reduction (BASELINE workload #5 for the ML
    estimator family; reference reduction point:
    src/phyc/treelikelihood.c:1483-1486)."""
    if mesh is not None:
        from ..parallel.mesh import replicate

        params = replicate(mesh, params)
    if method == "adam":
        return optimize_adam(log_prob, space, params, **kw)
    if method == "lbfgs":
        return optimize_lbfgs(log_prob, space, params, **kw)
    if method != "meta":
        raise ValueError(f"unknown method {method!r}")
    tol = kw.pop("tol", 1e-6)
    if n_starts > 1:
        params = _multistart_warmup(log_prob, space, params,
                                    n_starts=n_starts)
    # one jitted machine per optimizer, shared by every meta round:
    # re-tracing Adam/L-BFGS per round dominated wall-clock on fluA-sized
    # models (the L-BFGS zoom-linesearch graph alone compiles in tens of
    # seconds on CPU)
    loss = _make_loss(log_prob, space)
    lr = kw.pop("learning_rate", 0.05)
    adam_m = _adam_machine(loss, lr)
    lbfgs_m = _lbfgs_machine(loss)
    fn_jit = jax.jit(log_prob)
    res = optimize_adam(log_prob, space, params, tol=tol, learning_rate=lr,
                        max_iter=kw.pop("adam_iter", 2000),
                        _machine=adam_m, **kw)
    total_it = res.iterations
    for _round in range(10):
        res2 = optimize_lbfgs(log_prob, space, res.params, tol=tol,
                              _machine=lbfgs_m)
        total_it += res2.iterations
        if res2.logp > res.logp:
            res = res2
        # scalar Brent escape pass (reference: meta rounds re-run serial
        # Brent until the gain drops below tolfx)
        brent_params = _brent_scalar_pass(log_prob, space, res.params, tol,
                                          fn=fn_jit)
        blogp = float(log_prob(brent_params))
        improved = blogp > res.logp + max(tol, 1e-4)
        if improved:
            res = OptResult(brent_params, blogp, total_it, False)
            res3 = optimize_adam(log_prob, space, res.params, tol=tol,
                                 learning_rate=lr, max_iter=1000,
                                 _machine=adam_m)
            total_it += res3.iterations
            if res3.logp > res.logp:
                res = res3
        elif res2.logp <= res.logp + tol:
            break
    return OptResult(res.params, res.logp, total_it, True)


# -- checkpointing (reference: src/phyc/checkpoint.c name,value CSV) --------


def save_checkpoint(path: str, params: dict) -> None:
    """Atomic-ish name,value CSV (reference: checkpoint.c:40-62)."""
    lines = []
    for name, value in params.items():
        arr = np.ravel(np.asarray(value))
        if arr.size == 1:
            lines.append(f"{name},{float(arr[0]):.17g}")
        else:
            for i, v in enumerate(arr):
                lines.append(f"{name}.{i},{float(v):.17g}")
    tmp = path + ".new"
    with open(tmp, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    import os

    os.replace(tmp, path)


def load_checkpoint(path: str, params: dict) -> dict:
    """Restore values by name into an existing parameter pytree
    (reference: checkpoint.c checkpoint_apply)."""
    values: dict[str, float] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            name, _, val = line.rpartition(",")
            values[name] = float(val)
    out = {}
    for name, value in params.items():
        arr = np.array(np.asarray(value), dtype=np.float64)
        if arr.ndim == 0:
            if name in values:
                arr = np.asarray(values[name])
        else:
            for i in range(arr.size):
                k = f"{name}.{i}"
                if k in values:
                    arr.flat[i] = values[k]
        out[name] = jnp.asarray(arr)
    return out
