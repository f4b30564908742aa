"""Action execution: the `physher` run list of a config.

Rebuild of the reference's main action dispatcher (reference:
src/physher.c:207-305): optimizer, mcmc (+ loggers/operators), logger,
hessian, marginallikelihood, mmcmc, and friends. Actions share one mutable
parameter pool so sequential actions see each other's results (the
reference's shared Parameter objects in the hashtable).
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

from ..inference import ml, mcmc as mcmc_mod, vb as vb_mod, marginal
from ..models.parameters import ParamSpace
from .builder import Context
from .variational import VariationalHandle


class Runner:
    def __init__(self, ctx: Context, seed: int = 0, out=None):
        self.ctx = ctx
        self.seed = seed
        self.key = jax.random.PRNGKey(seed)
        self.pool: dict = {}
        self.out = out or sys.stdout
        self.results: dict = {}

    def next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    # -- parameter pool ----------------------------------------------------

    def params_for(self, space: ParamSpace) -> dict:
        init = space.init_params()
        return {k: self.pool.get(k, v) for k, v in init.items()}

    def update_pool(self, params: dict):
        self.pool.update(params)

    def model_logprob(self, model):
        return getattr(model, "log_prob", None) or model.log_likelihood

    # -- dispatch ----------------------------------------------------------

    def run(self, actions: list):
        for node in actions:
            typ = str(node.get("type", "")).lower()
            handler = getattr(self, f"action_{typ}", None)
            if handler is None:
                raise ValueError(f"unknown action type {typ!r}")
            handler(node)
        return self.results

    # -- actions -----------------------------------------------------------

    def action_optimizer(self, node):
        model = self.ctx.resolve(node.get("model"))
        algorithm = str(node.get("algorithm", "meta")).lower()
        max_iter = int(node.get("max", 1000))
        tol = float(node.get("precision", node.get("tol", 1e-3)))

        # meta schedules containing a topology sub-optimizer run the tree
        # search (which interleaves branch-length optimization itself;
        # reference: optimizer.c meta with OPT_TOPOLOGY + topologyopt.c)
        sub_algs = [str(s.get("algorithm", "")).lower()
                    for s in node.get("list", [])]
        if algorithm == "topology" or "topology" in sub_algs:
            move = "nni"
            for s in node.get("list", []) + [node]:
                if str(s.get("algorithm", "")).lower() == "topology":
                    move = str(s.get("move", "nni")).lower()
            return self._run_topology_search(node, model, move, tol)

        if isinstance(model, VariationalHandle):
            # SG/Adam on the ELBO (reference: optimizer.c OPT_SG/OPT_SG_ADAM
            # driving the variational model, JC69-time-ELBO.json)
            lr = float(node.get("eta", 0.05))
            res = vb_mod.fit(
                model.family, self.next_key(), steps=max_iter,
                learning_rate=lr, grad_samples=model.grad_samples,
                elbo_samples=model.elbo_samples, tol=tol,
                mesh=getattr(self.ctx, "mesh", None))
            model.vparams = res.vparams
            self.results[node.get("id", "vb")] = res
            print(f"ELBO: {res.elbo:.6f} ({res.iterations} iterations)",
                  file=self.out)
            return res

        log_prob = self.model_logprob(model)
        space = model.param_space()
        restrict = node.get("parameters")
        if not restrict and node.get("list"):
            restrict = self._schedule_scope(node, model)
        params = self.params_for(space)
        if restrict:
            names = self.ctx.resolve_target(restrict)
            sub_specs = [space.by_name[n] for n in names if n in space.by_name]
            sub_space = ParamSpace(sub_specs)
            fixed = {k: v for k, v in params.items()
                     if k not in {s.name for s in sub_specs}}
            fn = lambda p: log_prob({**fixed, **p})  # noqa: E731
            sub_params = {k: params[k] for k in sub_space.names}
            method = {"sg": "adam", "adam": "adam"}.get(algorithm, "meta")
            res = ml.optimize(fn, sub_space, sub_params, method=method,
                              tol=tol, mesh=getattr(self.ctx, "mesh", None))
            params.update(res.params)
        else:
            method = {"sg": "adam", "adam": "adam",
                      "lbfgs": "lbfgs", "bfgs": "lbfgs",
                      "cg": "lbfgs"}.get(algorithm, "meta")
            kw = {}
            if node.get("checkpoint"):
                kw["checkpoint"] = node["checkpoint"]
            if method == "meta":
                # CLI meta runs get the vmapped multi-start warmup
                # (robust to bad scalar inits like gamma shape 0.1,
                # e.g. examples/fluA/GTR-G4-ML.json)
                kw["n_starts"] = int(node.get("starts", 6))
            res = ml.optimize(log_prob, space, params, method=method,
                              tol=tol, mesh=getattr(self.ctx, "mesh", None),
                              **kw)
            params = dict(res.params)
        self.update_pool(params)
        self.results[node.get("id", "optimizer")] = res
        print(f"Maximum log likelihood: {res.logp:.6f} "
              f"({res.iterations} iterations)", file=self.out)
        return res

    def _schedule_scope(self, node, model):
        """Union of parameter names the meta schedule's sub-optimizers target.

        The reference meta-optimizer only runs its schedule's sub-optimizers
        (optimizer.c:154-210); a config whose schedule covers a subset of the
        parameters (e.g. jc69-time.json: one "serial" sub-optimizer over the
        treelikelihood's branch parameters, optimizer.c:100-152) must leave
        the rest (clock rate) fixed. Optimizing everything jointly is both
        wrong and — with include_jacobian and no prior — unbounded (rate→0,
        root height→inf rides the ratio-transform log|J| to +inf).

        Returns a list of parameter names, or None for the full space (any
        sub-optimizer without a recognizable restricted target).
        """
        from ..models.treelikelihood import TreeLikelihood

        names: list = []
        for s in node.get("list", []):
            alg = str(s.get("algorithm", "")).lower()
            if s.get("parameters"):
                names += [n for n in self.ctx.resolve_target(s["parameters"])]
                continue
            if alg in ("serial", "brent", "serialbrent"):
                tgt = self.ctx.resolve(
                    s.get("treelikelihood") or s.get("model")
                    or node.get("model"))
                tlk = getattr(tgt, "tlk", tgt)
                if isinstance(tlk, TreeLikelihood):
                    # branch-parameter analog: distances for unrooted trees,
                    # height reparameterization for time trees (the
                    # reference's serial Brent walks node->distance, which is
                    # meaningless for a time tree — verified: its own run on
                    # jc69-time.json degrades logP from -4786.87 to -24005.93)
                    if tlk.time_data is not None:
                        if tlk.height_transform == "shift":
                            names.append(tlk.key("shifts"))
                        else:
                            names += [tlk.key("ratios"),
                                      tlk.key("root_height")]
                    else:
                        names.append(tlk.key("distances"))
                    continue
            return None  # unrecognized sub-optimizer: keep full space
        return names or None

    def _run_topology_search(self, node, model, move, tol):
        from ..inference.topology_search import TopologySearch
        from ..models.treelikelihood import TreeLikelihood
        import numpy as np

        tlk = model

        def factory(topo, dist):
            return TreeLikelihood(
                tlk.sp, topo, tlk.subst, tlk.site_model,
                distances_init=np.nan_to_num(
                    np.asarray(dist)[: topo.N - 1], nan=0.05),
                tipstates=False, prefix=tlk.prefix, dtype=tlk.dtype)

        search = TopologySearch(factory, algorithm=move, tol=max(tol, 1e-3),
                                max_rounds=int(node.get("rounds", 50)))
        dist0 = np.concatenate([np.asarray(tlk.distances_init), [np.nan]])
        res = search.run(tlk.topo, dist0)
        # replace the registered likelihood with the final tree's
        final = factory(res.topology, res.distances)
        for key, obj in list(self.ctx.objects.items()):
            if obj is tlk:
                self.ctx.objects[key] = final
            if hasattr(obj, "is_time_tree") and obj.topo is tlk.topo:
                obj.topo = res.topology
                obj.distances = res.distances
        self.update_pool({tlk.key("distances"):
                          np.nan_to_num(res.distances[: res.topology.N - 1],
                                        nan=0.0)})
        self.results[node.get("id", "topology")] = res
        print(f"Topology search ({move}): logP {res.logp:.6f}, "
              f"{res.moves_accepted} moves accepted in {res.rounds} rounds",
              file=self.out)
        return res

    def action_mcmc(self, node):
        model = self.ctx.resolve(node.get("model"))
        log_prob = self.model_logprob(model)
        space = model.param_space()
        params = self.params_for(space)
        length = int(node.get("length", 100000))
        # operator weights -> per-spec proposal weights
        weights: dict = {}
        for op in node.get("operators", []):
            if str(op.get("algorithm", "")).lower() == "vb" \
                    or op.get("x") is None:
                continue  # vb/topology operators carry no parameter block
            names = self.ctx.resolve_target(op.get("x"))
            w = float(op.get("weight", 1.0))
            for n in names:
                weights[n] = weights.get(n, 0.0) + w
        # logging granularity = smallest logger "every"
        logs = node.get("log", [])
        every = min([int(l.get("every", 1000)) for l in logs] or [1000])

        # topology operators route to the tree MCMC (reference:
        # operator.c:584 "nni" operator inside the MCMC loop)
        algs = {str(op.get("algorithm", "")).lower()
                for op in node.get("operators", [])}
        from ..models.treelikelihood import TreeLikelihood as _TLK

        if "nni" in algs and isinstance(model, _TLK):
            return self._run_tree_mcmc(node, model, length, every)

        # "vb" operator: independence proposals from a fitted variational
        # distribution (reference: src/phyc/opvb.c, operator.c:419)
        vb_prop, vb_w = None, 1.0
        for op in node.get("operators", []):
            if str(op.get("algorithm", "")).lower() == "vb":
                vh = self.ctx.resolve(op.get("var", op.get("x")))
                if getattr(vh, "vparams", None) is None:
                    # fit on the fly (reference: opvb.c:96-150 builds and
                    # optimizes a variational model when none is supplied)
                    res = vb_mod.fit(vh.family, self.next_key(),
                                     steps=2000, tol=1e-4)
                    vh.vparams = res.vparams
                if vh.family.space.unconstrained_size != \
                        space.unconstrained_size:
                    raise ValueError(
                        "vb operator: variational space does not match "
                        "the MCMC model's parameter space")
                vb_prop = mcmc_mod.vb_proposal_from(vh.family, vh.vparams)
                vb_w = float(op.get("weight", 1.0))

        sampler = mcmc_mod.MCMC(space, log_prob,
                                weights=weights or None,
                                vb_proposal=vb_prop, vb_weight=vb_w)
        # multi-device: chains ride the mesh's chain axis, patterns its
        # data axis (config init.mesh / init.devices; ctx.mesh set by
        # builder._attach_mesh)
        mesh = getattr(self.ctx, "mesh", None)
        n_chains = int(node.get("chains", 0))
        if not n_chains:
            n_chains = (int(mesh.shape["chains"])
                        if mesh is not None and "chains" in mesh.shape
                        else 1)
        res = sampler.run(self.next_key(), params, n_iter=length,
                          every=every, n_chains=n_chains, mesh=mesh)
        self.results[node.get("id", "mcmc")] = res
        if getattr(res, "interrupted", False):
            print(f"MCMC interrupted: finalizing logs with "
                  f"{len(res.samples_u)} samples", file=self.out)
        self._write_mcmc_logs(node, res, space, every)
        # leave the pool at the last sample
        last = res.params_at(-1)
        self.update_pool(last)
        acc = ", ".join(f"{b}:{a:.2f}" for b, a in
                        zip(sampler.blocks, res.acceptance))
        print(f"MCMC finished: {length} iterations; acceptance {acc}",
              file=self.out)
        return res

    def _run_tree_mcmc(self, node, tlk, length, every):
        """MCMC with NNI topology moves (reference: operator.c nni operator;
        the chain samples topology + branch lengths + model parameters).

        ``"chains": B > 1`` in the mcmc node routes to the device-side
        vmapped-chain sampler (BatchedTreeMCMC: NNI as index edits inside
        one jitted scan; ``"incremental": true`` additionally carries
        partials-as-state for O(depth) updates on parameter-free models)."""
        n_chains = int(node.get("chains", 0))
        if n_chains > 1:
            return self._run_tree_mcmc_batched(node, tlk, length, every,
                                               n_chains)
        from ..inference.treemcmc import TreeMCMC

        sampler = TreeMCMC(tlk)
        params = self.params_for(sampler.space)
        res = sampler.run(self.next_key(), params, n_iter=length,
                          every=every)
        self.results[node.get("id", "mcmc")] = res
        states = (np.arange(len(res.trees)) + 1) * every
        for log_node in node.get("log", []):
            fname = log_node.get("file")
            if not fname:
                continue
            models = log_node.get("models", [])
            if isinstance(models, str):
                models = [models]
            is_treelog = (str(fname).endswith((".trees", ".nex", ".nxs"))
                          or any("tree" in str(m).lower() for m in models))
            if is_treelog:
                with open(self._path(fname), "w") as fh:
                    for s, t in zip(states, res.trees):
                        fh.write(t if t.endswith(";") else t + ";")
                        fh.write("\n")
            else:
                with open(self._path(fname), "w") as fh:
                    fh.write("state\tposterior\n")
                    for s, lp in zip(states, res.log_posterior):
                        fh.write(f"{int(s)}\t{lp:.10g}\n")
        self.update_pool(res.params_at(-1) if len(res.trees) else {})
        acc = ", ".join(f"{k}:{v:.2f}" for k, v in res.acceptance.items())
        print(f"MCMC finished: {length} iterations; acceptance {acc}",
              file=self.out)
        return res

    def _run_tree_mcmc_batched(self, node, tlk, length, every, n_chains):
        """Device-side vmapped-chain topology MCMC from the config surface.

        Chain 0's draws feed the reference-format tree/posterior logs (the
        reference logs one chain, src/phyc/logmcmc.c); the full per-chain
        sample batch stays available in ``results[id]``."""
        import jax.numpy as jnp

        from ..inference.treemcmc import BatchedTreeMCMC, children_to_newick

        sampler = BatchedTreeMCMC(tlk)
        incremental = bool(node.get("incremental", False)) and not sampler.dim
        params = self.params_for(sampler.space) if sampler.dim else None
        res = sampler.run(self.next_key(), params, n_iter=length,
                          every=every, n_chains=n_chains,
                          incremental=incremental)
        self.results[node.get("id", "mcmc")] = res
        S = res["logp"].shape[0]
        states = (np.arange(S) + 1) * every
        taxa = tlk.topo.taxa
        for log_node in node.get("log", []):
            fname = log_node.get("file")
            if not fname:
                continue
            models = log_node.get("models", [])
            if isinstance(models, str):
                models = [models]
            is_treelog = (str(fname).endswith((".trees", ".nex", ".nxs"))
                          or any("tree" in str(m).lower() for m in models))
            with open(self._path(fname), "w") as fh:
                if is_treelog:
                    for s in range(S):
                        fh.write(children_to_newick(
                            taxa, res["children"][s, 0], res["bl"][s, 0]))
                        fh.write("\n")
                else:
                    fh.write("state\tposterior\n")
                    for s in range(S):
                        fh.write(f"{int(states[s])}\t"
                                 f"{float(res['logp'][s, 0]):.10g}\n")
        if sampler.dim:
            space = res["space"]
            u_last = jnp.asarray(res["u"][-1, 0])
            self.update_pool(space.constrain(
                space.unflatten_unconstrained(u_last)))
        acc = ", ".join(f"{k}:{v:.2f}" for k, v in res["acceptance"].items())
        print(f"MCMC finished: {length} iterations x {n_chains} chains "
              f"(device-side topology moves); acceptance {acc}",
              file=self.out)
        return res

    def _write_mcmc_logs(self, node, res, space, base_every):
        cons = res.to_dict_of_arrays()
        S = res.samples_u.shape[0]
        for log_node in node.get("log", []):
            every = int(log_node.get("every", 1000))
            stride = max(1, every // base_every)
            idx = np.arange(0, S, stride)
            states = idx * base_every
            fname = log_node.get("file")
            models = log_node.get("models", [])
            if isinstance(models, str):
                models = [models]
            xs = log_node.get("x", [])
            if isinstance(xs, str):
                xs = [xs]
            # sitewise log-likelihood logger (reference: logmcmc.c Log with
            # per-site output consumed by cpo.c/predictive.c)
            if log_node.get("sitewise") and fname:
                tlk = None
                for m in models:
                    obj = self.ctx.resolve(m) if isinstance(m, str) else m
                    if hasattr(obj, "site_log_likelihoods"):
                        tlk = obj
                if tlk is not None:
                    zsel = jnp.asarray(res.samples_u[idx, 0])
                    batch = jax.jit(jax.vmap(
                        lambda z: tlk.site_log_likelihoods(space.constrain(
                            space.unflatten_unconstrained(z)))))
                    site = np.asarray(batch(zsel))
                    w = np.asarray(tlk.sp.weights)
                    lines = ["#" + "\t".join(f"{x:g}" for x in w),
                             "\t".join(["state"] + [
                                 f"site{i}" for i in range(site.shape[1])])]
                    for s, row in zip(states, site):
                        lines.append("\t".join(
                            [str(int(s))] + [f"{v:.10g}" for v in row]))
                    with open(self._path(fname), "w") as fh:
                        fh.write("\n".join(lines) + "\n")
                    continue
            # tree logger?
            tree_handle = None
            for m in models:
                obj = self.ctx.resolve(m) if isinstance(m, str) else m
                if hasattr(obj, "is_time_tree"):
                    tree_handle = obj
            if tree_handle is not None and fname:
                self._write_tree_log(fname, tree_handle, res, idx, states)
                continue
            # tabular logger
            cols: list = ["state"]
            series: list = [states]
            zsel = jnp.asarray(res.samples_u[idx, 0])
            for m in models:
                obj = self.ctx.resolve(m) if isinstance(m, str) else m
                if hasattr(obj, "log_prob") or hasattr(obj, "log_likelihood"):
                    fn = self.model_logprob(obj)
                    batch = jax.jit(jax.vmap(lambda z: fn(space.constrain(
                        space.unflatten_unconstrained(z)))))
                    vals = np.asarray(batch(zsel))
                    cols.append(m.lstrip("&$%"))
                    series.append(vals)
                elif isinstance(m, str):
                    for name in self.ctx.resolve_target(m):
                        if name in cons:
                            arr = cons[name][idx, 0]
                            arr2 = arr.reshape(len(idx), -1)
                            for j in range(arr2.shape[1]):
                                cols.append(f"{name}.{j}" if arr2.shape[1] > 1
                                            else name)
                                series.append(arr2[:, j])
            for x in xs:
                for name in self.ctx.resolve_target(x):
                    if name not in cons:
                        continue
                    arr = cons[name][idx, 0].reshape(len(idx), -1)
                    for j in range(arr.shape[1]):
                        cols.append(f"{name}.{j}" if arr.shape[1] > 1
                                    else name)
                        series.append(arr[:, j])
            table = np.column_stack(series)
            lines = ["\t".join(cols)]
            for row in table:
                lines.append("\t".join(
                    str(int(row[0])) if c == 0 else f"{v:.10g}"
                    for c, v in enumerate(row)))
            text = "\n".join(lines) + "\n"
            if fname:
                with open(self._path(fname), "w") as fh:
                    fh.write(text)
            else:
                print(text[:2000], file=self.out)

    def _write_tree_log(self, fname, handle, res, idx, states):
        from ..io.treeio import write_newick
        from ..trees.heights import branch_durations

        topo = handle.topo
        lines = ["#NEXUS", "begin trees;"]
        for s, i in zip(states, idx):
            p = res.params_at(int(i))
            if handle.is_time_tree:
                h = handle.heights(p)
                dist = np.asarray(branch_durations(h, topo))
            else:
                d = np.asarray(p[handle.key("distances")])
                dist = np.concatenate([d, [np.nan]])
            lines.append(
                f"tree STATE_{int(s)} = {write_newick(topo, dist)}")
        lines += ["end;", ""]
        with open(self._path(fname), "w") as fh:
            fh.write("\n".join(lines))

    def _path(self, p):
        import os

        if os.path.isabs(p):
            return p
        return os.path.join(self.ctx.base_dir, p)

    def action_logger(self, node):
        """One-shot logger (reference: src/phyc/logger.c)."""
        tree = self.ctx.resolve(node.get("tree")) if node.get("tree") else None
        if tree is not None and hasattr(tree, "is_time_tree"):
            from ..io.treeio import write_newick
            from ..trees.heights import branch_durations

            space_holder = self.ctx.objects.get("treelikelihood")
            if tree.is_time_tree and space_holder is not None:
                params = self.params_for(space_holder.param_space())
                h = tree.heights(params)
                dist = np.asarray(branch_durations(h, tree.topo))
            else:
                dist = self.pool.get(tree.key("distances"))
                if dist is None:
                    dist = np.asarray(tree.distances)[: tree.topo.N - 1]
                dist = np.concatenate([np.asarray(dist), [np.nan]])
            print(write_newick(tree.topo, dist), file=self.out)
        models = node.get("models", [])
        if isinstance(models, str):
            models = [models]
        for m in models:
            obj = self.ctx.resolve(m)
            if hasattr(obj, "log_prob") or hasattr(obj, "log_likelihood"):
                fn = self.model_logprob(obj)
                params = self.params_for(obj.param_space())
                print(f"{m.lstrip('&')}: {float(fn(params)):.6f}",
                      file=self.out)

    # -- likelihood analyses (reference: physher.c:289-305 actions) --------

    def _tlk_and_params(self, node, key="model"):
        tlk = self.ctx.resolve(node.get(key, node.get("treelikelihood",
                                                      "&treelikelihood")))
        return tlk, self.params_for(tlk.param_space())

    def action_asr(self, node):
        from ..likelihood.analysis import ancestral_sequences

        tlk, params = self._tlk_and_params(node)
        seqs = ancestral_sequences(tlk, params)
        self.results[node.get("id", "asr")] = seqs
        fname = node.get("file")
        if fname:
            from ..io.seqio import write_fasta

            write_fasta(seqs, self._path(fname))
        else:
            for k in list(seqs)[:3]:
                print(f">{k}\n{seqs[k][:60]}...", file=self.out)
        return seqs

    def action_ppsite(self, node):
        from ..likelihood.analysis import site_rate_posteriors

        tlk, params = self._tlk_and_params(node)
        post = site_rate_posteriors(tlk, params)
        self.results[node.get("id", "ppsite")] = post
        fname = node.get("file")
        if fname:
            np.savetxt(self._path(fname), post.T, fmt="%.6g", delimiter="\t")
        return post

    def action_cat(self, node):
        from ..likelihood.analysis import cat_assignment

        tlk, params = self._tlk_and_params(node)
        cats = cat_assignment(tlk, params)
        self.results[node.get("id", "cat")] = cats
        fname = node.get("file")
        if fname:
            np.savetxt(self._path(fname), cats, fmt="%d")
        return cats

    def action_simultron(self, node):
        """Sequence simulation (reference: physher.c:289-292, physim.c)."""
        from ..likelihood.analysis import simulate_alignment
        from ..io.seqio import write_fasta, write_nexus_alignment

        tlk, params = self._tlk_and_params(node)
        n_sites = int(node.get("length", node.get("sites",
                                                  tlk.sp.site_count)))
        bl = np.asarray(tlk.branch_lengths(params))
        seqs = simulate_alignment(self.next_key(), tlk.topo, tlk.subst,
                                  tlk.site_model, params, bl, n_sites)
        fname = node.get("output", node.get("file"))
        if fname:
            fmt = str(node.get("format", "fasta")).lower()
            if fmt == "nexus":
                write_nexus_alignment(seqs, self._path(fname))
            else:
                write_fasta(seqs, self._path(fname))
        self.results[node.get("id", "simultron")] = seqs
        return seqs

    def action_sbn(self, node):
        """SBN estimation from a tree log (reference: physher.c:293, sbn.c)."""
        from ..inference.sbn import SBN
        from ..io.treeio import TreeFileIterator

        fname = node.get("file", node.get("trees"))
        sbn = SBN()
        burnin = float(node.get("burnin", 0.0))
        trees = list(TreeFileIterator(self._path(fname)))
        start = int(len(trees) * burnin)
        for topo, _ in trees[start:]:
            sbn.add_tree(topo)
        roots, conds = sbn.probabilities()
        print(f"SBN: {len(roots)} rootsplits, {len(conds)} parent clades "
              f"from {sbn.n_trees:.0f} trees", file=self.out)
        self.results[node.get("id", "sbn")] = sbn
        return sbn

    def action_mmcmc(self, node):
        """Tempered-ladder MCMC, batched over temperatures (reference:
        src/phyc/mmcmc.c — which runs them sequentially)."""
        from ..inference import marginal as marg

        model = self.ctx.resolve(node.get("model"))
        # expect a compound: likelihood + prior split
        like, prior = self._split_like_prior(model)
        space = model.param_space()
        params = self.params_for(space)
        n_temps = int(node.get("temperatures", node.get("steps", 16)))
        length = int(node.get("length", 10000))
        temps, lls, res = marg.run_tempered_ladder(
            self.next_key(), space, like, prior, params, n_temps=n_temps,
            n_iter=length, every=int(node.get("every", 10)),
            burnin=int(node.get("burnin", length // 10)),
            distribution_power=float(node.get("power", 0.3)),
            mesh=getattr(self.ctx, "mesh", None))
        self.results[node.get("id", "mmcmc")] = (temps, lls, res)
        ss, _ = marg.log_stepping_stone(lls, temps)
        ps, _ = marg.log_path_sampling(lls, temps)
        print(f"log marginal likelihood: stepping-stone {ss:.4f}, "
              f"path-sampling {ps:.4f}", file=self.out)
        return temps, lls, res

    def _split_like_prior(self, model):
        """Split a compound model into (likelihood, prior) callables."""
        from ..models.distributions import CompoundModel
        from ..models.treelikelihood import TreeLikelihood

        if isinstance(model, CompoundModel):
            likes = [c for c in model.components
                     if isinstance(c, TreeLikelihood)]
            priors = [c for c in model.components
                      if not isinstance(c, TreeLikelihood)]
            like = lambda p: sum(l.log_likelihood(p) for l in likes)  # noqa
            prior = lambda p: sum((c.log_prob(p) for c in priors), 0.0)  # noqa
            return like, prior
        return self.model_logprob(model), lambda p: 0.0

    def action_marginallikelihood(self, node):
        """Estimate marginal likelihood from a stored mmcmc result
        (reference: marginal.c _marginal_likelihood_run reads logs)."""
        from ..inference import marginal as marg

        ref = node.get("mmcmc", "mmcmc")
        stored = self.results.get(ref.lstrip("&") if isinstance(ref, str)
                                  else "mmcmc")
        if stored is None:
            raise ValueError("marginallikelihood needs a prior mmcmc action")
        temps, lls, _ = stored
        methods = node.get("methods",
                           ["stepping", "path", "harmonic", "stabilized"])
        out = {}
        for m in methods:
            if m in ("stepping", "ss"):
                out[m] = marg.log_stepping_stone(lls, temps)[0]
            elif m in ("path", "ps"):
                out[m] = marg.log_path_sampling(lls, temps)[0]
            elif m == "path2":
                out[m] = marg.log_path_sampling_modified(lls, temps)[0]
            elif m == "harmonic":
                out[m] = marg.log_harmonic_mean(lls[-1])
            elif m == "stabilized":
                out[m] = marg.log_stabilized_harmonic_mean(lls[-1])
            elif m == "arithmetic":
                out[m] = marg.log_arithmetic_mean(lls[0])
        for m, v in out.items():
            print(f"{m}: {v:.6f}", file=self.out)
        self.results[node.get("id", "marginal")] = out
        return out

    def action_laplace(self, node):
        """Laplace marginal likelihood. "distribution" selects the envelope
        family (reference: src/phyc/laplace.c:965-1050 dispatch —
        gamma/lognormal/beta/betaprime per-parameter fits or the
        multivariate-normal default)."""
        from ..inference import marginal as marg

        model = self.ctx.resolve(node.get("model"))
        space = model.param_space()
        params = self.params_for(space)
        dist = node.get("distribution")
        if isinstance(dist, dict):
            dist = dist.get("distribution")
        dist = str(dist or "multivariatenormal").lower()
        if dist in ("multivariatenormal", "normal", "mvn"):
            val = marg.laplace_marginal(self.model_logprob(model), space,
                                        params)
        else:
            names = None
            if node.get("x") is not None:
                names = set(self.ctx.resolve_target(node["x"]))
            val = marg.laplace_marginal_fitted(
                self.model_logprob(model), space, params, family=dist,
                names=names)
        print(f"Laplace log marginal likelihood: {val:.6f}", file=self.out)
        self.results[node.get("id", "laplace")] = val
        return val

    def action_bridgesampling(self, node):
        from ..inference import marginal as marg
        from ..inference import mcmc as mcmc_mod

        model = self.ctx.resolve(node.get("model"))
        space = model.param_space()
        params = self.params_for(space)
        log_prob = self.model_logprob(model)
        sampler = mcmc_mod.MCMC(space, log_prob)
        res = sampler.run(self.next_key(), params,
                          n_iter=int(node.get("length", 20000)),
                          every=10, burnin=int(node.get("burnin", 2000)))
        su = jnp.asarray(res.samples_u.reshape(-1, res.samples_u.shape[-1]))

        def log_unnorm(z):
            up = space.unflatten_unconstrained(z)
            return log_prob(space.constrain(up)) + space.log_jacobian(up)

        val = marg.bridge_sampling_marginal(su, log_unnorm, space,
                                            self.next_key())
        print(f"Bridge-sampling log marginal likelihood: {val:.6f}",
              file=self.out)
        self.results[node.get("id", "bridge")] = val
        return val

    def action_is(self, node):
        """Importance-sampling marginal with a variational proposal
        (reference: src/phyc/is.c, action 'is'/'vbis')."""
        from ..inference import marginal as marg

        var = self.ctx.resolve(node.get("variational", node.get("model")))
        n = int(node.get("samples", 1000))
        log_prob = self.model_logprob(var.posterior)
        val = marg.importance_sampling_marginal(
            self.next_key(), var.family, var.vparams, log_prob, n_samples=n)
        print(f"IS log marginal likelihood: {val:.6f}", file=self.out)
        self.results[node.get("id", "is")] = val
        return val

    def action_nest(self, node):
        from ..inference import marginal as marg

        model = self.ctx.resolve(node.get("model"))
        like, prior = self._split_like_prior(model)
        space = model.param_space()
        params = self.params_for(space)
        u0 = space.flatten_unconstrained(space.unconstrain(params))
        dim = u0.shape[0]

        def sample_prior(key, n):
            # diffuse overdispersed start around the current point
            return u0 + 2.0 * jax.random.normal(key, (n, dim), dtype=u0.dtype)

        val = marg.nested_sampling(
            self.next_key(), space, like, sample_prior,
            n_live=int(node.get("points", 100)),
            max_iter=int(node.get("max", 5000)))
        print(f"Nested-sampling log evidence (approx): {val:.6f}",
              file=self.out)
        self.results[node.get("id", "nest")] = val
        return val

    def action_cpo(self, node):
        """CPO / LPML from per-site log-likelihood samples of an MCMC run
        (reference: src/phyc/cpo.c reads sitewise logs)."""
        from ..inference.modelselection import cpo as cpo_fn

        if node.get("filename"):
            # reference file format: '#'-prefixed weight line, header,
            # then state\tsite... rows (cpo.c:16-75)
            burnin = int(node.get("burnin", 0))
            weights, site_lls = _read_sitewise_log(
                self._path(node["filename"]), burnin)
            log_cpo, lpml = cpo_fn(site_lls, weights)
            print(f"LPML: {lpml:.6f}", file=self.out)
            self.results[node.get("id", "cpo")] = (log_cpo, lpml)
            return log_cpo, lpml
        ref = str(node.get("mcmc", "mcmc")).lstrip("&")
        res = self.results.get(ref)
        tlk, _ = self._tlk_and_params(node, key="treelikelihood")
        if res is None:
            raise ValueError("cpo needs a prior mcmc action")
        space = res.space
        z = jnp.asarray(res.samples_u[:, 0])
        batch = jax.jit(jax.vmap(lambda zz: tlk.site_log_likelihoods(
            space.constrain(space.unflatten_unconstrained(zz)))))
        site_lls = np.asarray(batch(z))
        log_cpo, lpml = cpo_fn(site_lls, tlk.sp.weights)
        print(f"LPML: {lpml:.6f}", file=self.out)
        self.results[node.get("id", "cpo")] = (log_cpo, lpml)
        return log_cpo, lpml

    def action_mc(self, node):
        """Plain Monte Carlo marginal: average likelihood under prior draws
        (reference: src/phyc/mc.c)."""
        from ..inference import marginal as marg

        model = self.ctx.resolve(node.get("model"))
        like, prior = self._split_like_prior(model)
        space = model.param_space()
        params = self.params_for(space)
        # sample from the prior via MCMC on the prior only
        from ..inference import mcmc as mcmc_mod

        sampler = mcmc_mod.MCMC(space, lambda p: prior(p))
        res = sampler.run(self.next_key(), params,
                          n_iter=int(node.get("length", 10000)), every=10,
                          burnin=1000)
        z = jnp.asarray(res.samples_u[:, 0])
        batch = jax.jit(jax.vmap(lambda zz: like(
            space.constrain(space.unflatten_unconstrained(zz)))))
        lls = np.asarray(batch(z))
        val = marg.log_arithmetic_mean(lls)
        print(f"MC log marginal likelihood: {val:.6f}", file=self.out)
        self.results[node.get("id", "mc")] = val
        return val

    def action_predictive(self, node):
        """Posterior-predictive simulation check (reference:
        src/phyc/predictive.c)."""
        from ..likelihood.analysis import simulate_alignment
        from ..inference.modelselection import posterior_predictive_pvalue

        tlk, params = self._tlk_and_params(node)
        n_sims = int(node.get("samples", 100))

        def stat(sp):
            return sp.pattern_count  # simple diversity statistic

        obs = stat(tlk.sp)
        sims = []
        bl = np.asarray(tlk.branch_lengths(params))
        from ..data.sitepattern import SitePattern

        for _ in range(n_sims):
            seqs = simulate_alignment(self.next_key(), tlk.topo, tlk.subst,
                                      tlk.site_model, params, bl,
                                      tlk.sp.site_count)
            sims.append(stat(SitePattern.from_alignment(seqs,
                                                        tlk.sp.datatype)))
        p = posterior_predictive_pvalue(obs, sims)
        print(f"posterior predictive p-value (pattern diversity): {p:.3f}",
              file=self.out)
        self.results[node.get("id", "predictive")] = p
        return p

    def action_dumper(self, node):
        """Dump current parameter values as JSON for restart (reference:
        src/phyc/logger.c Dumper)."""
        import json

        out = {}
        for name, val in self.pool.items():
            arr = np.asarray(val)
            out[name] = arr.tolist() if arr.ndim else float(arr)
        fname = node.get("file")
        if fname:
            with open(self._path(fname), "w") as fh:
                json.dump(out, fh, indent=1)
        else:
            print(json.dumps(out)[:1000], file=self.out)
        return out

    def action_hessian(self, node):
        model = self.ctx.resolve(node.get("model"))
        log_prob = self.model_logprob(model)
        space = model.param_space()
        params = self.params_for(space)
        u = space.flatten_unconstrained(space.unconstrain(params))

        def f(z):
            return log_prob(space.constrain(space.unflatten_unconstrained(z)))

        # reverse-over-reverse Hessian (reference FD Hessian:
        # src/phyc/hessian.c)
        H = np.asarray(jax.jacrev(jax.grad(f))(u))
        self.results[node.get("id", "hessian")] = H
        print("Hessian (unconstrained space):", file=self.out)
        print(np.array2string(H, precision=6), file=self.out)
        return H


def _read_sitewise_log(path: str, burnin: int = 0):
    """Parse the reference's sitewise log format: first line '#'-prefixed
    tab-separated site weights, then a header, then state\\tvalue rows
    (reference: cpo.c:26-52, predictive.c:25-55)."""
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
    weights = np.asarray([float(x) for x in lines[0][1:].split("\t")])
    rows = []
    for ln in lines[2:]:
        parts = ln.split("\t")
        rows.append([float(x) for x in parts[1:]])
    site_lls = np.asarray(rows[burnin:])
    return weights, site_lls
