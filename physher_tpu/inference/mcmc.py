"""MCMC: Metropolis-Hastings with block proposals, batched chains, tempering.

Rebuild of the reference's MCMC engine (reference: src/phyc/mcmc.c:60-185
store/propose/accept loop, src/phyc/operator.c operator suite with 0.24
acceptance self-tuning at operator.c:403-414, src/phyc/mmcmc.c temperature
ladders) redesigned for XLA:

- the chain state is a flat unconstrained vector; proposals are Gaussian
  random walks on parameter blocks (one block per ParamSpec), which subsumes
  the reference's scaler/slider/randomwalk operators after the constrain
  transform (a scaler on x>0 IS a random walk on log x with logHR folded
  into the Jacobian term),
- the kernel is a jitted ``lax.scan``; there is no store/restore machinery —
  the rejected state is just kept (the reference's O(1) buffer flips exist
  only because its recompute was incremental),
- chains vectorize with ``vmap`` (the reference runs one chain; its
  temperature ladder runs sequentially at mmcmc.c:48-88 — here the ladder is
  a batched axis),
- step sizes adapt between scan chunks toward 0.24 acceptance.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.parameters import ParamSpace


@dataclass
class MCMCResult:
    samples_u: np.ndarray        # [n_samples, n_chains, dim] unconstrained
    log_posterior: np.ndarray    # [n_samples, n_chains]
    log_likelihood: np.ndarray   # [n_samples, n_chains] (if like/prior split)
    acceptance: np.ndarray       # [n_blocks] final acceptance rates
    step_sizes: np.ndarray
    space: ParamSpace = None
    # True when the run was cut short by SIGINT between chunks; samples hold
    # what was collected so far (reference: mcmc.c:21-28 clean finalize)
    interrupted: bool = False

    def params_at(self, i, chain=0):
        u = self.space.unflatten_unconstrained(jnp.asarray(
            self.samples_u[i, chain]))
        return self.space.constrain(u)

    def to_dict_of_arrays(self):
        """Constrained samples stacked per parameter: {name: [S, C, ...]}."""
        S, C, _ = self.samples_u.shape
        flat = jnp.asarray(self.samples_u.reshape(S * C, -1))
        cons = jax.vmap(lambda z: self.space.constrain(
            self.space.unflatten_unconstrained(z)))(flat)
        return {k: np.asarray(v).reshape((S, C) + v.shape[1:])
                for k, v in cons.items()}


class HMC:
    """Hamiltonian Monte Carlo over a ParamSpace (reference: src/phyc/
    ophmc.c — leapfrog with the model's dlogP; here the gradient is
    jax.grad of the unconstrained log-posterior and chains vectorize
    with vmap, the batched replacement for the reference's
    single-operator HMC).
    """

    def __init__(self, space: ParamSpace, log_prob: Callable, *,
                 n_leapfrog: int = 10):
        self.space = space
        self.log_prob = log_prob
        self.L = n_leapfrog
        self._dim = space.unconstrained_size
        self._run_chunk = None  # compiled once (see MCMC._compiled_chunk)

    def _target(self, z):
        uparams = self.space.unflatten_unconstrained(z)
        return (self.log_prob(self.space.constrain(uparams))
                + self.space.log_jacobian(uparams))

    def run(self, key, params: dict, *, n_iter: int = 1000, every: int = 1,
            n_chains: int = 4, step_size: float = 0.05, burnin: int = 100,
            adapt: bool = True, target_accept: float = 0.8) -> MCMCResult:
        space = self.space
        dim = self._dim
        u0 = space.flatten_unconstrained(space.unconstrain(params))
        key, sub = jax.random.split(key)
        us = u0 + 0.01 * jax.random.normal(sub, (n_chains, dim),
                                           dtype=u0.dtype)
        val_grad = jax.value_and_grad(self._target)

        def _kernel(state, key, eps):
            u, logp, glogp = state
            k1, k2 = jax.random.split(key)
            p0 = jax.random.normal(k1, u.shape, dtype=u.dtype)

            def leap(carry, _):
                q, p, g = carry
                p = p + 0.5 * eps * g
                q = q + eps * p
                _, g = val_grad(q)
                p = p + 0.5 * eps * g
                return (q, p, g), None

            (q, p, g), _ = jax.lax.scan(
                leap, (u, p0, glogp), None, length=self.L)
            new_logp, new_g = val_grad(q)
            log_alpha = (new_logp - logp
                         - 0.5 * jnp.sum(p * p) + 0.5 * jnp.sum(p0 * p0))
            ok = (jnp.log(jax.random.uniform(k2, dtype=u.dtype)) < log_alpha)
            ok = ok & jnp.isfinite(new_logp)
            return (jnp.where(ok, q, u), jnp.where(ok, new_logp, logp),
                    jnp.where(ok, new_g, glogp)), ok

        if self._run_chunk is None:
            @jax.jit
            def run_chunk(states, keys, eps):
                def one_chain(state, keys):
                    def body(st, k):
                        st, ok = _kernel(st, k, eps)
                        return st, ok
                    st, oks = jax.lax.scan(body, state, keys)
                    return st, jnp.mean(oks.astype(jnp.float32))
                return jax.vmap(one_chain)(states, keys)

            self._run_chunk = run_chunk
            self._init_eval = jax.jit(jax.vmap(val_grad))
        run_chunk = self._run_chunk

        lp0, g0 = self._init_eval(us)
        states = (us, lp0, g0)
        n_samples = n_iter // every
        burn_chunks = burnin // every
        samples = np.empty((n_samples, n_chains, dim))
        lps = np.empty((n_samples, n_chains))
        eps = step_size
        si = 0
        acc_hist = []
        for ci in range(n_samples + burn_chunks):
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, n_chains * every).reshape(
                n_chains, every, 2)
            states, acc = run_chunk(states, keys, eps)
            rate = float(jnp.mean(acc))
            acc_hist.append(rate)
            if adapt and ci < burn_chunks:
                eps *= float(np.exp(0.5 * (rate - target_accept)))
            if ci >= burn_chunks:
                samples[si] = np.asarray(states[0])
                lps[si] = np.asarray(states[1])
                si += 1
        return MCMCResult(samples, lps, lps.copy(),
                          np.asarray(acc_hist), np.asarray([eps]), space)


def vb_proposal_from(family, vparams):
    """(sample_fn, logq_fn) over the flat unconstrained vector from a
    fitted variational family (``MeanFieldNormalVB``/``FullRankNormalVB``)
    — the MCMC independence-proposal form of the reference's "vb"
    operator (src/phyc/opvb.c)."""
    def sample_fn(key):
        return family.sample_unconstrained(vparams, key, 1)[0]

    def logq_fn(u):
        return family.log_q(vparams, u)

    return sample_fn, logq_fn


class MCMC:
    """Metropolis within jit over a ParamSpace.

    ``log_like``/``log_prior`` enable tempered targets
    logP_T = T * log_like + log_prior (+ unconstraining Jacobian); with only
    ``log_prob`` the target is untempered.
    """

    def __init__(self, space: ParamSpace, log_prob: Callable = None, *,
                 log_like: Callable = None, log_prior: Callable = None,
                 log_ref: Callable = None, weights: dict | None = None,
                 vb_proposal=None, vb_weight: float = 1.0):
        self.space = space
        if log_prob is None and log_like is None:
            raise ValueError("need log_prob or log_like")
        self.log_prob = log_prob
        self.log_like = log_like
        self.log_prior = log_prior
        # generalized stepping stone: with a reference (working) distribution
        # the tempered target is (like*prior)^T * ref^(1-T)
        # (reference: mmcmc.c:18-105 GSS mode)
        self.log_ref = log_ref
        # independence proposals from a fitted variational distribution
        # (reference: src/phyc/opvb.c "vb" operator — whose own logHR is an
        # acknowledged TODO at opvb.c:55; here the Hastings correction
        # log q(u) - log q(u') is applied): vb_proposal =
        # (sample_fn(key) -> u[dim], logq_fn(u) -> scalar) over the flat
        # unconstrained vector, e.g. from MeanFieldNormalVB via
        # ``vb_proposal_from``.
        self.vb_proposal = vb_proposal
        self.vb_weight = float(vb_weight)
        # one proposal block per free spec
        self.blocks = []
        idx = 0
        dim = space.unconstrained_size
        self._dim = dim
        masks = []
        w = []
        for s in space.free_specs():
            n = s.unconstrained_size
            m = np.zeros(dim)
            m[idx: idx + n] = 1.0
            masks.append(m)
            weight = (weights or {}).get(s.name, float(n))
            w.append(weight)
            self.blocks.append(s.name)
            idx += n
        if self.vb_proposal is not None:
            # extra roulette slot for the independence move; mask unused
            masks.append(np.zeros(dim))
            w.append(self.vb_weight)
            self.blocks.append("<vb>")
        self.masks = jnp.asarray(np.stack(masks))
        self.weights = jnp.asarray(np.asarray(w) / np.sum(w))
        # compiled sampler functions, built once per instance: defining
        # them inside run() recompiled the MH scan on EVERY call (~2 s on
        # fluA — r4's benched "throughput" was mostly XLA compile time;
        # the traced device cost is ~43 us/proposal single-chain)
        self._run_chunk = None
        self._init_eval = None

    # -- targets -----------------------------------------------------------

    def _split_target(self, z, temperature):
        uparams = self.space.unflatten_unconstrained(z)
        params = self.space.constrain(uparams)
        jac = self.space.log_jacobian(uparams)
        if self.log_like is not None:
            ll = self.log_like(params)
            lp = self.log_prior(params) if self.log_prior else 0.0
            if self.log_ref is not None:
                ref = self.log_ref(params)
                base = ll + lp
                # recorded "log-likelihood" is the GSS ratio statistic
                return (temperature * base + (1.0 - temperature) * ref + jac,
                        base - ref)
            return temperature * ll + lp + jac, ll
        lp = self.log_prob(params)
        return lp + jac, lp

    # -- sampling ----------------------------------------------------------

    def _compiled_chunk(self):
        """Build (once) the jitted chunk kernel; jit caches per input
        shape, so repeat runs and chain-count sweeps reuse executables."""
        if self._run_chunk is not None:
            return self._run_chunk

        masks = self.masks
        weights = self.weights
        vb = self.vb_proposal
        n_blocks = len(self.blocks)

        def kernel(state, key, sigmas, temp):
            u, logp, ll, acc, tries = state
            k1, k2, k3, k4 = jax.random.split(key, 4)
            b = jax.random.choice(k1, n_blocks, p=weights)
            eps = jax.random.normal(k2, u.shape, dtype=u.dtype)
            u_new = u + sigmas[b] * masks.astype(u.dtype)[b] * eps
            log_hr = jnp.zeros((), u.dtype)
            if vb is not None:
                sample_fn, logq_fn = vb
                u_vb = sample_fn(k4).astype(u.dtype)
                is_vb = b == n_blocks - 1
                u_new = jnp.where(is_vb, u_vb, u_new)
                # Hastings ratio for an independence proposal:
                # q(current)/q(proposed)
                log_hr = jnp.where(is_vb, logq_fn(u) - logq_fn(u_vb), 0.0)
            logp_new, ll_new = self._split_target(u_new, temp)
            log_alpha = logp_new - logp + log_hr
            accept = jnp.log(jax.random.uniform(k3, dtype=u.dtype)) < log_alpha
            accept = accept & jnp.isfinite(logp_new)
            u = jnp.where(accept, u_new, u)
            logp = jnp.where(accept, logp_new, logp)
            ll = jnp.where(accept, ll_new, ll)
            acc = acc.at[b].add(accept.astype(u.dtype))
            tries = tries.at[b].add(1.0)
            return (u, logp, ll, acc, tries)

        @jax.jit
        def run_chunk(states, keys, sigmas, temps):
            def one_chain(state, keys, temp):
                def body(state, key):
                    return kernel(state, key, sigmas, temp), None

                state, _ = jax.lax.scan(body, state, keys)
                return state

            return jax.vmap(one_chain)(states, keys, temps)

        self._run_chunk = run_chunk
        self._init_eval = jax.jit(
            jax.vmap(lambda u, t: self._split_target(u, t)))
        return run_chunk

    def run(self, key, params: dict, *, n_iter: int = 10000, every: int = 10,
            n_chains: int = 1, temperatures=None, adapt: bool = True,
            adapt_interval: int = 200, burnin: int = 0,
            init_step: float = 0.1, init_jitter: float = 0.0,
            mesh=None, chain_axis: str = "chains") -> MCMCResult:
        """``mesh``: place the chain batch on a device mesh — the chain
        dimension shards over ``chain_axis`` (if the mesh has it) while the
        target's pattern-sharded likelihood constants ride the mesh's data
        axis (config surface: ``init.mesh``; the reference runs one chain
        per process, src/phyc/mcmc.c:60-185)."""
        space = self.space
        dim = self._dim
        u0 = space.flatten_unconstrained(space.unconstrain(params))
        if temperatures is None:
            temps = jnp.ones(n_chains)
        else:
            temps = jnp.asarray(temperatures, dtype=u0.dtype)
            n_chains = temps.shape[0]
        key, sub = jax.random.split(key)
        us = jnp.tile(u0, (n_chains, 1))
        if init_jitter:
            us = us + init_jitter * jax.random.normal(sub, us.shape,
                                                      dtype=u0.dtype)
        if mesh is not None and chain_axis in mesh.shape:
            from jax.sharding import NamedSharding, PartitionSpec

            if n_chains % mesh.shape[chain_axis]:
                raise ValueError(
                    f"n_chains={n_chains} not divisible by mesh axis "
                    f"{chain_axis}={mesh.shape[chain_axis]}")
            us = jax.device_put(
                us, NamedSharding(mesh, PartitionSpec(chain_axis)))
            temps = jax.device_put(
                temps, NamedSharding(mesh, PartitionSpec(chain_axis)))
        sigmas = jnp.full(len(self.blocks), init_step, dtype=u0.dtype)

        run_chunk = self._compiled_chunk()

        # initial state
        init_lp = self._init_eval(us, temps)
        states = (us, init_lp[0], init_lp[1],
                  jnp.zeros((n_chains, len(self.blocks)), dtype=u0.dtype),
                  jnp.zeros((n_chains, len(self.blocks)), dtype=u0.dtype))

        n_samples = n_iter // every
        burn_chunks = burnin // every
        samples = np.empty((n_samples, n_chains, dim), dtype=np.float64)
        lps = np.empty((n_samples, n_chains))
        lls = np.empty((n_samples, n_chains))
        adapt_every_chunks = max(1, adapt_interval // every)
        sigmas_np = sigmas

        total_chunks = n_samples + burn_chunks
        si = 0
        cum_acc = np.zeros(len(self.blocks))
        cum_tries = np.zeros(len(self.blocks))
        interrupted = False
        # SIGINT between chunks finalizes cleanly with the samples collected
        # so far (reference: mcmc.c:21-28 SIGINT flag + clean logger close)
        try:
            for ci in range(total_chunks):
                key, sub = jax.random.split(key)
                keys = jax.random.split(sub, n_chains * every).reshape(
                    n_chains, every, 2)
                states = run_chunk(states, keys, sigmas_np, temps)
                if ci >= burn_chunks:
                    samples[si] = np.asarray(states[0])
                    lps[si] = np.asarray(states[1])
                    lls[si] = np.asarray(states[2])
                    si += 1
                if adapt and (ci + 1) % adapt_every_chunks == 0:
                    acc = np.asarray(states[3]).sum(0)
                    tries = np.asarray(states[4]).sum(0)
                    cum_acc += acc
                    cum_tries += tries
                    rate = np.where(tries > 0, acc / np.maximum(tries, 1),
                                    0.24)
                    factor = np.exp(np.clip(rate - 0.24, -0.5, 0.5))
                    sigmas_np = sigmas_np * jnp.asarray(factor)
                    states = (states[0], states[1], states[2],
                              jnp.zeros_like(states[3]),
                              jnp.zeros_like(states[4]))
        except KeyboardInterrupt:
            interrupted = True

        cum_acc += np.asarray(states[3]).sum(0)
        cum_tries += np.asarray(states[4]).sum(0)
        res = MCMCResult(
            samples[:si], lps[:si], lls[:si],
            np.where(cum_tries > 0, cum_acc / np.maximum(cum_tries, 1),
                     np.nan),
            np.asarray(sigmas_np), space)
        res.interrupted = interrupted
        return res

class MixedMCMC:
    """MH over a continuous ParamSpace PLUS a binary indicator vector.

    Rebuild of the reference's bitflip operator on DiscreteParameters
    (reference: src/phyc/operator.c bitflip entry; used for SSVS clock-model
    averaging via branch-model indicators, branchmodel.h:64-67, and Bayesian
    skyline group assignments). The indicator vector rides inside the jitted
    ``lax.scan`` kernel as an int32 vector; a bitflip proposal flips one
    uniformly chosen bit (symmetric, log q ratio = 0).

    ``log_prob(params, bits)`` is the unnormalized target over constrained
    parameters and the indicator vector.
    """

    def __init__(self, space: ParamSpace, log_prob: Callable, n_bits: int,
                 *, p_flip: float = 0.3):
        self.space = space
        self.log_prob = log_prob
        self.n_bits = int(n_bits)
        self.p_flip = float(p_flip)
        self.blocks = [s.name for s in space.free_specs()]
        dim = space.unconstrained_size
        masks, idx = [], 0
        for s in space.free_specs():
            m = np.zeros(dim)
            m[idx: idx + s.unconstrained_size] = 1.0
            masks.append(m)
            idx += s.unconstrained_size
        self.masks = jnp.asarray(np.stack(masks)) if masks else None
        self._dim = dim

    def _target(self, u, bits):
        uparams = self.space.unflatten_unconstrained(u)
        params = self.space.constrain(uparams)
        return self.log_prob(params, bits) + self.space.log_jacobian(uparams)

    def run(self, key, params: dict, bits0, *, n_iter: int = 10000,
            every: int = 10, init_step: float = 0.1, adapt: bool = True,
            adapt_interval: int = 200, burnin: int = 0):
        space = self.space
        u0 = space.flatten_unconstrained(space.unconstrain(params))
        bits0 = jnp.asarray(bits0, dtype=jnp.int32)
        n_blocks = max(len(self.blocks), 1)
        sigmas = jnp.full(n_blocks, init_step, dtype=u0.dtype)
        masks = (self.masks.astype(u0.dtype) if self.masks is not None
                 else jnp.zeros((1, self._dim), dtype=u0.dtype))
        p_flip = self.p_flip if self.n_bits else 0.0

        def kernel(state, key, sigmas):
            u, bits, logp, acc, tries = state
            k1, k2, k3, k4, k5 = jax.random.split(key, 5)
            do_flip = jax.random.uniform(k1) < p_flip
            # continuous proposal
            b = jax.random.randint(k2, (), 0, n_blocks)
            eps = jax.random.normal(k3, u.shape, dtype=u.dtype)
            u_cont = u + sigmas[b] * masks[b] * eps
            # bitflip proposal
            j = jax.random.randint(k4, (), 0, max(self.n_bits, 1))
            bits_flip = bits.at[j].set(1 - bits[j])
            u_new = jnp.where(do_flip, u, u_cont)
            bits_new = jnp.where(do_flip, bits_flip, bits)
            logp_new = self._target(u_new, bits_new)
            accept = (jnp.log(jax.random.uniform(k5, dtype=u.dtype))
                      < logp_new - logp) & jnp.isfinite(logp_new)
            u = jnp.where(accept, u_new, u)
            bits = jnp.where(accept, bits_new, bits)
            logp = jnp.where(accept, logp_new, logp)
            slot = jnp.where(do_flip, n_blocks, b)
            acc = acc.at[slot].add(accept.astype(u.dtype))
            tries = tries.at[slot].add(1.0)
            return (u, bits, logp, acc, tries)

        @jax.jit
        def run_chunk(state, keys, sigmas):
            def body(state, key):
                return kernel(state, key, sigmas), None

            state, _ = jax.lax.scan(body, state, keys)
            return state

        logp0 = self._target(u0, bits0)
        state = (u0, bits0, logp0,
                 jnp.zeros(n_blocks + 1, dtype=u0.dtype),
                 jnp.zeros(n_blocks + 1, dtype=u0.dtype))
        n_samples = n_iter // every
        burn_chunks = burnin // every
        us = np.empty((n_samples, self._dim))
        bit_samples = np.empty((n_samples, max(self.n_bits, 1)), dtype=np.int32)
        lps = np.empty(n_samples)
        si = 0
        adapt_chunks = max(1, adapt_interval // every)
        for ci in range(n_samples + burn_chunks):
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, every)
            state = run_chunk(state, keys, sigmas)
            if ci >= burn_chunks:
                us[si] = np.asarray(state[0])
                bit_samples[si] = np.asarray(state[1])
                lps[si] = float(state[2])
                si += 1
            if adapt and (ci + 1) % adapt_chunks == 0:
                acc, tries = np.asarray(state[3]), np.asarray(state[4])
                rate = np.where(tries[:-1] > 0,
                                acc[:-1] / np.maximum(tries[:-1], 1), 0.24)
                sigmas = sigmas * jnp.asarray(
                    np.exp(np.clip(rate - 0.24, -0.5, 0.5)))
                state = (state[0], state[1], state[2],
                         jnp.zeros_like(state[3]), jnp.zeros_like(state[4]))
        acc, tries = np.asarray(state[3]), np.asarray(state[4])
        return {
            "samples_u": us, "bits": bit_samples, "log_posterior": lps,
            "acceptance": np.where(tries > 0, acc / np.maximum(tries, 1),
                                   np.nan),
            "space": space,
        }
