"""Topology MCMC: Metropolis-Hastings over topologies, branch lengths and
substitution/site parameters.

Rebuild of the reference's tree operators inside MCMC (reference:
src/phyc/operator.c:419-626 `_operator_nni` / scaler / slider entries,
dispatched from the mcmc.c:112-142 store/propose/accept loop). Device-first
redesign:

- the likelihood evaluator is compiled ONCE with the topology as runtime
  data (``ops/dynamic_pruning.tree_loglik_dynamic``): children index arrays,
  tip-row permutation and branch lengths are device inputs, so topology
  proposals never retrace/recompile (the reference instead mutates its
  incremental C object graph in place),
- proposals mix three move families — NNI on a uniformly chosen internal
  edge (symmetric: every binary topology on T taxa has the same number of
  rooted-NNI rearrangements, so log q ratio = 0), a log-space scaler on one
  branch length (Hastings ratio log m, operator.c scaler semantics), and a
  Gaussian random walk on one unconstrained parameter block (subsumes the
  reference's scaler/slider operators after the constrain transform),
- move-size self-tuning targets 0.24 acceptance (operator.c:403-414),
- tree samples are returned as newick strings (the reference's tree log,
  logmcmc.h) so SBN / clade-support post-processing consumes them directly.

The NNI bookkeeping (nested-dict surgery, postorder renumbering) is host
work per proposal; the likelihood itself is one device call. For small
phylogenetic state spaces this is proposal-latency-bound either way — the
batched-chain upgrade is to vmap the evaluator over per-chain children
arrays (see ops/dynamic_pruning.batched_tree_loglik).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..models.parameters import ParamSpace
from ..ops.dynamic_pruning import tree_loglik_dynamic
from ..trees.topology import Topology
from .topology_search import to_nested, nni_neighbors


@dataclass
class TreeMCMCResult:
    trees: list                  # newick strings, every `every` iterations
    samples_u: np.ndarray        # [S, dim] unconstrained parameter samples
    branch_lengths: np.ndarray   # [S, N] per-node branch lengths
    log_posterior: np.ndarray    # [S]
    acceptance: dict             # per move family
    space: ParamSpace = None
    final_topology: Topology = None
    final_distances: np.ndarray = None
    history: list = field(default_factory=list)

    def params_at(self, i):
        u = self.space.unflatten_unconstrained(jnp.asarray(self.samples_u[i]))
        return self.space.constrain(u)


def _candidate_arrays(topo: Topology, dist, base_names):
    children = np.asarray(topo.children[:, :2], dtype=np.int32)
    perm = np.asarray([base_names[t] for t in topo.taxa], dtype=np.int32)
    bl = np.nan_to_num(np.asarray(dist, dtype=np.float64), nan=0.0)
    return children, perm, bl


class TreeMCMC:
    """MH over (topology, branch lengths, model parameters) for an unrooted
    ``TreeLikelihood`` (binary rooted representation; reversible models are
    root-placement invariant).

    ``log_prior(params, bl)`` is an optional joint prior over the constrained
    model parameters and the per-node branch-length vector; by default an
    exponential(10) prior is placed on branch lengths (the reference configs'
    usual choice) and the parameter prior is flat.
    """

    def __init__(self, tlk, *, log_prior=None, bl_prior_rate: float = 10.0):
        self.tlk = tlk
        specs = [s for s in tlk.param_space().specs
                 if s.name != tlk.key("distances")]
        self.space = ParamSpace(specs)
        self._base_names = {t: i for i, t in enumerate(tlk.topo.taxa)}
        self.log_prior = log_prior
        self.bl_prior_rate = float(bl_prior_rate)
        self._eval = self._make_eval()

    def _make_eval(self):
        tlk, space = self.tlk, self.space
        tp = jnp.asarray(tlk.tip_partials)
        w = tlk.weights

        @jax.jit
        def logpost(u, children, perm, bl):
            params = space.constrain(space.unflatten_unconstrained(u))
            rates, props = tlk.site_model.rates_props(params)
            freqs = tlk.subst.frequencies(params)
            blc = jnp.clip(bl, 0.0, None)[:, None] * rates[None, :]
            pmats = tlk.subst.p_t(params, blc).astype(tlk.dtype)
            ll = tree_loglik_dynamic(
                tp[perm], pmats, children, freqs.astype(tlk.dtype),
                props.astype(tlk.dtype), w, rescale=tlk.rescale)[0]
            lp = ll + space.log_jacobian(space.unflatten_unconstrained(u))
            if self.log_prior is not None:
                lp = lp + self.log_prior(params, bl)
            else:
                r = self.bl_prior_rate
                n_br = bl.shape[0] - 1  # root branch unused
                lp = lp + n_br * jnp.log(r) - r * jnp.sum(bl[:-1])
            return lp

        return logpost

    # -- proposals ----------------------------------------------------------

    def _propose_nni(self, rng, nested):
        neighbors = nni_neighbors(nested)
        if not neighbors:
            return None
        return neighbors[rng.integers(len(neighbors))], 0.0

    def run(self, key, params: dict, *, n_iter: int = 10000,
            every: int = 100, burnin: int = 0, p_topo: float = 0.2,
            p_bl: float = 0.4, init_step: float = 0.1,
            bl_lambda: float = 1.0, adapt: bool = True,
            adapt_interval: int = 200, seed: int = 0) -> TreeMCMCResult:
        from ..io.treeio import write_newick

        tlk, space = self.tlk, self.space
        rng = np.random.default_rng(
            int(jax.random.randint(key, (), 0, 2**31 - 1)) ^ seed)
        topo = tlk.topo
        dist = np.array(tlk.distances_init, dtype=np.float64)
        # per-node branch lengths (root entry unused)
        bl = np.zeros(topo.N)
        bl[: dist.shape[0]] = dist
        nested = to_nested(topo, bl)

        u = np.asarray(space.flatten_unconstrained(space.unconstrain(params)))
        blocks = list(space.free_specs())
        block_slices = []
        off = 0
        for s in blocks:
            block_slices.append((off, off + s.unconstrained_size))
            off += s.unconstrained_size
        sigmas = np.full(len(blocks), init_step)
        lam = bl_lambda

        children, perm, bl = _candidate_arrays(topo, bl, self._base_names)
        logp = float(self._eval(jnp.asarray(u), children, perm, bl))

        acc = {"nni": [0, 0], "branch": [0, 0], "param": [0, 0]}
        acc_win = {"branch": [0, 0], "param": [0, 0]}
        trees, samples, bls, lps = [], [], [], []

        if not blocks:
            # no free model parameters: renormalize over topology+branch
            tot = p_topo + p_bl
            p_topo, p_bl = p_topo / tot, p_bl / tot

        for it in range(n_iter):
            r = rng.random()
            if r < p_topo and topo.I > 1:
                move = "nni"
                prop = self._propose_nni(rng, nested)
                if prop is not None:
                    cand_nested, log_hr = prop
                    topo_c, dist_c = Topology.from_nested(cand_nested)
                    ch_c, perm_c, bl_c = _candidate_arrays(
                        topo_c, dist_c, self._base_names)
                    logp_new = float(self._eval(jnp.asarray(u), ch_c, perm_c,
                                                bl_c))
                    if (np.isfinite(logp_new)
                            and np.log(rng.random())
                            < logp_new - logp + log_hr):
                        nested, topo = cand_nested, topo_c
                        children, perm, bl = ch_c, perm_c, bl_c
                        logp = logp_new
                        acc["nni"][0] += 1
                    acc["nni"][1] += 1
            elif r < p_topo + p_bl:
                move = "branch"
                j = rng.integers(topo.N - 1)
                m = np.exp(lam * (rng.random() - 0.5))
                bl_new = bl.copy()
                bl_new[j] = bl[j] * m
                logp_new = float(self._eval(jnp.asarray(u), children, perm,
                                            bl_new))
                if (np.isfinite(logp_new)
                        and np.log(rng.random()) < logp_new - logp
                        + np.log(m)):
                    bl = bl_new
                    logp = logp_new
                    acc["branch"][0] += 1
                    acc_win["branch"][0] += 1
                acc["branch"][1] += 1
                acc_win["branch"][1] += 1
                self._sync_nested_lengths(nested, topo, bl)
            else:
                move = "param"
                b = rng.integers(len(blocks))
                lo, hi = block_slices[b]
                u_new = u.copy()
                u_new[lo:hi] = u[lo:hi] + sigmas[b] * rng.standard_normal(
                    hi - lo)
                logp_new = float(self._eval(jnp.asarray(u_new), children,
                                            perm, bl))
                if (np.isfinite(logp_new)
                        and np.log(rng.random()) < logp_new - logp):
                    u = u_new
                    logp = logp_new
                    acc["param"][0] += 1
                    acc_win["param"][0] += 1
                acc["param"][1] += 1
                acc_win["param"][1] += 1

            if adapt and (it + 1) % adapt_interval == 0:
                for name, arr in acc_win.items():
                    if arr[1] == 0:
                        continue
                    rate = arr[0] / arr[1]
                    f = np.exp(np.clip(rate - 0.24, -0.5, 0.5))
                    if name == "branch":
                        lam *= f
                    else:
                        sigmas *= f
                    arr[0] = arr[1] = 0

            if it >= burnin and (it + 1) % every == 0:
                trees.append(write_newick(topo, bl))
                samples.append(u.copy())
                bls.append(bl.copy())
                lps.append(logp)

        return TreeMCMCResult(
            trees=trees,
            samples_u=np.asarray(samples) if samples else np.empty((0, u.size)),
            branch_lengths=np.asarray(bls) if bls else np.empty((0, topo.N)),
            log_posterior=np.asarray(lps),
            acceptance={k: (v[0] / v[1] if v[1] else np.nan)
                        for k, v in acc.items()},
            space=space, final_topology=topo, final_distances=bl)

    @staticmethod
    def _sync_nested_lengths(nested, topo: Topology, bl):
        """Write the per-node branch lengths back into the nested dict (kept
        in lockstep so NNI proposals carry current lengths)."""

        def walk(node, node_id):
            if node_id != topo.root:
                node["length"] = float(bl[node_id])
            if node_id >= topo.T:
                k = node_id - topo.T
                for j, c in enumerate(node["children"]):
                    walk(c, int(topo.children[k, j]))

        walk(nested, topo.root)


def children_to_newick(taxa, children, bl=None) -> str:
    """Newick string from a device-sampler [I, 2] children array.

    Node ids follow the BatchedTreeMCMC convention (tips ``< T``, internal
    row ``k`` = id ``T + k``, root = last row). NNI edits can break the
    children-before-parents rank invariant, so this walks ids rather than
    building a :class:`Topology` (whose validator enforces postorder)."""
    import sys

    taxa = list(taxa)
    T = len(taxa)
    I = len(children)
    root = T + I - 1
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10 * (T + I) + 100))
    try:
        def fmt(nid):
            if nid < T:
                s = taxa[nid]
            else:
                s = "(" + ",".join(fmt(int(c))
                                   for c in children[nid - T]) + ")"
            if bl is not None and nid != root:
                s += f":{float(bl[nid]):.10g}"
            return s

        return fmt(root) + ";"
    finally:
        sys.setrecursionlimit(old)


class BatchedTreeMCMC:
    """Vmapped-chain topology MCMC with NNI as DEVICE index edits.

    The round-4 design (``TreeMCMC``) does host-side Python tree surgery
    per proposal — correct but proposal-latency-bound. Here the whole
    sampler state lives on device — per-chain children arrays [B, I, 2],
    branch lengths [B, N] and unconstrained model parameters [B, dim] —
    and the entire chunk of proposals runs as one jitted
    ``vmap(lax.scan)``:

    - NNI is two row edits on the children array
      (ops/dynamic_pruning.propose_nni_device, matching the reference's
      NNI operator src/phyc/operator.c:419-626 inside the mcmc.c loop),
    - the evaluation order is recomputed per proposal from the edited
      children by height fixed-point (postorder_from_children), so no
      renumbering and no recompilation ever happens,
    - branch-length moves are the reference's log-space scaler (Hastings
      ratio log m), parameter moves a Gaussian walk on the unconstrained
      block.

    The per-chain branch-length prior is exponential(``bl_prior_rate``),
    the reference configs' usual choice.
    """

    def __init__(self, tlk, *, bl_prior_rate: float = 10.0,
                 p_nni: float = 0.4, p_bl: float = 0.4):
        self.tlk = tlk
        specs = [s for s in tlk.param_space().specs
                 if s.name != tlk.key("distances")]
        self.space = ParamSpace(specs)
        self.dim = self.space.unconstrained_size
        self.bl_prior_rate = float(bl_prior_rate)
        self.p_nni = float(p_nni)
        # with no free parameters the walk slot folds into the scaler
        self.p_bl = float(p_bl) if self.dim else 1.0 - float(p_nni)
        self._logpost = self._make_logpost()
        # compiled once per instance (jit caches per shape) — defining the
        # jitted chunk inside run() would recompile every call
        self._chunk_cache = {}

    def _make_logpost(self):
        from ..ops.dynamic_pruning import (
            postorder_from_children, tree_loglik_dynamic_ordered)

        tlk = self.tlk
        space = self.space
        tp = jnp.asarray(tlk.tip_partials)
        w = jnp.asarray(tlk.weights)
        T = tlk.topo.T
        rate = self.bl_prior_rate

        def logpost(children, bl, u):
            uparams = space.unflatten_unconstrained(u)
            params = space.constrain(uparams)
            rates, props = tlk.site_model.rates_props(params)
            freqs = tlk.subst.frequencies(params)
            blc = jnp.clip(bl, 0.0, None)[:, None] * rates[None, :]
            pmats = tlk.subst.p_t(params, blc).astype(tlk.dtype)
            order = postorder_from_children(children, T)
            ll = tree_loglik_dynamic_ordered(
                tp, pmats, children, order, freqs.astype(tlk.dtype),
                props.astype(tlk.dtype), w, rescale=tlk.rescale)[0]
            lp = ll + space.log_jacobian(uparams)
            n_br = bl.shape[0] - 1
            return lp + n_br * jnp.log(rate) - rate * jnp.sum(bl[:-1])

        return logpost

    def run(self, key, params: dict = None, *, n_iter: int = 2000,
            every: int = 20, n_chains: int = 8, burnin: int = 0,
            bl_lambda: float = 0.6, param_step: float = 0.1,
            init_jitter: float = 0.0, incremental: bool = False):
        """Returns dict with per-chunk samples of children/bl/u/logp
        stacked as [n_samples, n_chains, ...] plus acceptance rates.

        ``incremental=True`` (parameter-free models only) carries the
        per-chain partials as sampler state and recomputes ONLY the
        root path after each move — the device analog of the
        reference's dirty-flag incremental recompute + O(1)
        store/restore (src/phyc/treelikelihood.c:126-161); rejection is
        the ``jnp.where`` keeping the old state. O(depth) node updates
        per proposal instead of O(N)."""
        if incremental:
            if self.dim:
                raise ValueError("incremental tree-MCMC supports "
                                 "parameter-free models (substitution/"
                                 "site parameters held fixed)")
            return self._run_incremental(
                key, n_iter=n_iter, every=every, n_chains=n_chains,
                burnin=burnin, bl_lambda=bl_lambda)
        from ..ops.dynamic_pruning import propose_nni_device

        tlk = self.tlk
        topo = tlk.topo
        T, N, I = topo.T, topo.N, topo.I
        space = self.space
        if params is None:
            params = space.init_params()
        u0 = space.flatten_unconstrained(space.unconstrain(params)) \
            if self.dim else jnp.zeros(1)
        dt = u0.dtype
        ch0 = jnp.asarray(topo.children[:, :2], jnp.int32)
        bl0 = jnp.concatenate([
            jnp.asarray(np.nan_to_num(tlk.distances_init, nan=0.1), dt),
            jnp.zeros(1, dt)])
        p_nni, p_bl, dim = self.p_nni, self.p_bl, self.dim
        logpost = self._logpost
        ck = (float(bl_lambda), float(param_step))
        if ck not in self._chunk_cache:
            def kernel(state, key):
                children, bl, u, logp, acc = state
                k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
                mv = jax.random.uniform(k1)
                is_nni = mv < p_nni
                is_bl = (mv >= p_nni) & (mv < p_nni + p_bl)
                ch_new, _ = propose_nni_device(k2, children, T)
                children_p = jnp.where(is_nni, ch_new, children)
                j = jax.random.randint(k3, (), 0, N - 1)
                m = jnp.exp(bl_lambda
                            * (jax.random.uniform(k4, dtype=dt) - 0.5))
                bl_p = jnp.where(is_bl, bl.at[j].mul(m), bl)
                u_p = jnp.where(is_nni | is_bl, u,
                                u + param_step * jax.random.normal(
                                    k5, u.shape, dtype=dt))
                log_hr = jnp.where(is_bl, jnp.log(m), 0.0)
                lp_new = logpost(children_p, bl_p, u_p)
                ok = (jnp.log(jax.random.uniform(k6, dtype=dt))
                      < lp_new - logp + log_hr) & jnp.isfinite(lp_new)
                children = jnp.where(ok, children_p, children)
                bl = jnp.where(ok, bl_p, bl)
                u = jnp.where(ok, u_p, u)
                logp = jnp.where(ok, lp_new, logp)
                slot = jnp.where(is_nni, 0, jnp.where(is_bl, 1, 2))
                acc = acc.at[slot, 0].add(ok.astype(dt))
                acc = acc.at[slot, 1].add(1.0)
                return (children, bl, u, logp, acc)

            @jax.jit
            def run_chunk(states, keys):
                def one_chain(state, keys):
                    def body(st, k):
                        return kernel(st, k), None

                    st, _ = jax.lax.scan(body, state, keys)
                    return st

                return jax.vmap(one_chain)(states, keys)

            self._chunk_cache[ck] = (run_chunk, jax.jit(jax.vmap(logpost)))
        run_chunk, init_eval = self._chunk_cache[ck]

        key, sub = jax.random.split(key)
        us = jnp.tile(u0, (n_chains, 1))
        if init_jitter and dim:
            us = us + init_jitter * jax.random.normal(sub, us.shape,
                                                      dtype=dt)
        chs = jnp.tile(ch0, (n_chains, 1, 1))
        bls = jnp.tile(bl0, (n_chains, 1))
        lps = init_eval(chs, bls, us)
        states = (chs, bls, us, lps,
                  jnp.zeros((n_chains, 3, 2), dtype=dt))

        n_samples = max(n_iter // every, 1)
        burn_chunks = burnin // every
        out = {"children": [], "bl": [], "u": [], "logp": []}
        for ci in range(n_samples + burn_chunks):
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, n_chains * every).reshape(
                n_chains, every, 2)
            states = run_chunk(states, keys)
            if ci >= burn_chunks:
                out["children"].append(np.asarray(states[0]))
                out["bl"].append(np.asarray(states[1]))
                out["u"].append(np.asarray(states[2]))
                out["logp"].append(np.asarray(states[3]))
        acc = np.asarray(states[4]).sum(0)
        res = {k: np.stack(v) for k, v in out.items()}
        res["acceptance"] = {
            name: float(acc[i, 0] / max(acc[i, 1], 1.0))
            for i, name in enumerate(("nni", "branch", "params"))}
        res["space"] = space
        return res

    def _run_incremental(self, key, *, n_iter, every, n_chains, burnin,
                         bl_lambda):
        """Partials-as-state sampler (see ``run(incremental=True)``)."""
        from ..ops.dynamic_pruning import (
            parent_array, postorder_from_children, propose_nni_device,
            root_loglik_from_partials, tree_partials_dynamic_ordered,
            update_path_partials)

        tlk = self.tlk
        topo = tlk.topo
        T, N = topo.T, topo.N
        tp = jnp.asarray(tlk.tip_partials)
        w = jnp.asarray(tlk.weights)
        dt = w.dtype
        params0 = {}  # dim == 0 guarded by run()
        rates, props = tlk.site_model.rates_props(params0)
        freqs = tlk.subst.frequencies(params0).astype(dt)
        props = props.astype(dt)
        rate = self.bl_prior_rate
        p_nni = self.p_nni
        rescale = tlk.rescale
        subst = tlk.subst

        def pmats_of(bl):
            blc = jnp.clip(bl, 0.0, None)[:, None] * rates[None, :]
            return subst.p_t(params0, blc).astype(dt)

        def prow_of(blj):
            blc = jnp.clip(blj, 0.0, None)[None, None] * rates[None, :]
            return subst.p_t(params0, blc)[0].astype(dt)

        def logpost_of(buf, scal, bl):
            ll = root_loglik_from_partials(buf, scal, freqs, props, w,
                                           rescale=rescale)[0]
            n_br = bl.shape[0] - 1
            return ll + n_br * jnp.log(rate) - rate * jnp.sum(bl[:-1])

        ck = ("incr", float(bl_lambda))
        if ck not in self._chunk_cache:
            def kernel(state, key):
                children, bl, pmats, buf, scal, logp, acc = state
                k1, k2, k3, k4, k6 = jax.random.split(key, 5)
                is_nni = jax.random.uniform(k1) < p_nni
                ch_nni, c = propose_nni_device(k2, children, T)
                children_p = jnp.where(is_nni, ch_nni, children)
                j = jax.random.randint(k3, (), 0, N - 1)
                m = jnp.exp(bl_lambda
                            * (jax.random.uniform(k4, dtype=dt) - 0.5))
                bl_p = jnp.where(is_nni, bl, bl.at[j].mul(m))
                pmats_p = jnp.where(is_nni, pmats,
                                    pmats.at[j].set(prow_of(bl_p[j])))
                parent = parent_array(children_p, T)
                start = jnp.where(is_nni, c, parent[j])
                buf_p, scal_p = update_path_partials(
                    buf, scal, pmats_p, children_p, start, T,
                    rescale=rescale, parent=parent)
                lp_new = logpost_of(buf_p, scal_p, bl_p)
                log_hr = jnp.where(is_nni, 0.0, jnp.log(m))
                ok = (jnp.log(jax.random.uniform(k6, dtype=dt))
                      < lp_new - logp + log_hr) & jnp.isfinite(lp_new)
                children = jnp.where(ok, children_p, children)
                bl = jnp.where(ok, bl_p, bl)
                pmats = jnp.where(ok, pmats_p, pmats)
                buf = jnp.where(ok, buf_p, buf)
                scal = jnp.where(ok, scal_p, scal)
                logp = jnp.where(ok, lp_new, logp)
                slot = jnp.where(is_nni, 0, 1)
                acc = acc.at[slot, 0].add(ok.astype(dt))
                acc = acc.at[slot, 1].add(1.0)
                return (children, bl, pmats, buf, scal, logp, acc)

            @jax.jit
            def run_chunk(states, keys):
                def one_chain(state, keys):
                    def body(st, k):
                        return kernel(st, k), None

                    st, _ = jax.lax.scan(body, state, keys)
                    return st

                return jax.vmap(one_chain)(states, keys)

            @jax.jit
            def init_state(children, bl):
                pmats = pmats_of(bl)
                order = postorder_from_children(children, T)
                buf, scal = tree_partials_dynamic_ordered(
                    tp, pmats, children, order, rescale=rescale)
                return pmats, buf, scal, logpost_of(buf, scal, bl)

            self._chunk_cache[ck] = (run_chunk, jax.vmap(init_state))
        run_chunk, init_state = self._chunk_cache[ck]

        ch0 = jnp.asarray(topo.children[:, :2], jnp.int32)
        bl0 = jnp.concatenate([
            jnp.asarray(np.nan_to_num(tlk.distances_init, nan=0.1), dt),
            jnp.zeros(1, dt)])
        chs = jnp.tile(ch0, (n_chains, 1, 1))
        bls = jnp.tile(bl0, (n_chains, 1))
        pmats, buf, scal, lps = init_state(chs, bls)
        states = (chs, bls, pmats, buf, scal, lps,
                  jnp.zeros((n_chains, 2, 2), dtype=dt))

        n_samples = max(n_iter // every, 1)
        burn_chunks = burnin // every
        out = {"children": [], "bl": [], "logp": []}
        for ci in range(n_samples + burn_chunks):
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, n_chains * every).reshape(
                n_chains, every, 2)
            states = run_chunk(states, keys)
            if ci >= burn_chunks:
                out["children"].append(np.asarray(states[0]))
                out["bl"].append(np.asarray(states[1]))
                out["logp"].append(np.asarray(states[5]))
        acc = np.asarray(states[6]).sum(0)
        res = {k: np.stack(v) for k, v in out.items()}
        res["acceptance"] = {
            name: float(acc[i, 0] / max(acc[i, 1], 1.0))
            for i, name in enumerate(("nni", "branch"))}
        res["space"] = self.space
        return res
