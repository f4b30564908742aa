"""Benchmark suite: prints ONE JSON line {"metric","value","unit",
"vs_baseline", "extras": {...}}.

Headline metric: site-patterns/s of full value+gradient evaluation of a
GTR+Gamma(4) time-tree likelihood (128 taxa, 16384 patterns) on one device.
All f32 matmuls run at full float32 precision (physher_tpu/__init__.py).

Reference-CPU baselines (HISTORY: measured once, on an earlier machine, from
the reference C source, single core + SSE; they cannot be re-measured here,
so the ``*_vs_ref_cpu`` ratios below compare against that record only):

  GTR+Gamma4, 128 taxa x 16384 patterns (synthetic, the EXACT workload
    below), reference analytic-gradient path via tools/reforacle.c:
    logP 49.78 ms, value+grad 398.22 ms
    -> 329,132 patterns/s forward, 41,144 patterns/s value+grad
  WAG+Gamma4, 64 taxa x 8192 aa patterns: logP 155.55 ms, v+g 863.23 ms
    -> 52,665 / 9,490 patterns/s
  Codon GY94 M0, 32 taxa x 4096 codon patterns: logP 401.20 ms
    -> 10,209 patterns/s forward. The reference has NO WORKING analytic
    codon gradient (treelikelihoodCodon.c:1855 "TODO: add
    calculate_branch_likelihood for codon", and its codon kernels
    segfault via the raw-API construction path — tools/reforacle_codon.c);
    its only functioning codon gradient is central finite differences:
    2*62 branch evals + 1 => 125 x 401.2 ms = 50.2 s -> 81.7 patterns/s.
  fluA JC69 strict-clock time tree (tests/data/jc69-time.json, 238
    patterns): logP 0.0844 ms, value+grad 0.4524 ms.
  fluA ELBO end-to-end (examples/fluA/JC69-time-ELBO.json, the FULL
    reference binary built by tools/build_reference_full.sh): 10,000
    ADVI iterations in 8 s -> 1,250 iterations/s, converging to
    ELBO -4651.23 +- 0.5 across 4 seeds (tests/data/goldens/fluA_elbo.json).
  fluA MCMC end-to-end (examples/fluA/HKY-MCMC.json, full reference
    binary, incremental recompute + all operators): 1,000,000 proposals
    in 96.69 s -> 10,342 proposals/s (single chain). Effective-sample
    quality of the same run (round 5, re-run in 69.5 s this window):
    Geyer ESS of the joint log-posterior over its own samples.log
    (1000 draws, 10% burnin) = 860 -> 12.4 ESS/s; per-parameter ESS/s
    12.3-13.0 (its thin-by-1000 samples are nearly independent, so its
    ESS rate is wall-clock-limited). Our mcmc_ess_per_s measures the
    same statistic on the jc69-time model's log-posterior across 512
    vmapped chains — a comparable-dimension fluA posterior, not the
    identical config.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

REF = {
    # historical reference-CPU rates on identical workloads (provenance above)
    "gtrg4_value_grad": 16384 / 0.39822,
    "gtrg4_forward": 16384 / 0.049777,
    "wag_value_grad": 8192 / 0.86323,
    "wag_forward": 8192 / 0.15555,
    "codon_forward": 4096 / 0.40120,
    "codon_value_grad_fd": 4096 / 50.15,   # FD: the only working ref path
    "elbo_iters_per_s": 1250.0,            # end-to-end reference ADVI
    "elbo_final": -4651.23,                # converged reference ELBO
    "timetree_logp_per_s": 1.0 / 0.0844e-3,
    "mcmc_proposals_per_s": 1e6 / 96.69,   # end-to-end reference MCMC
    "mcmc_ess_per_s": 12.4,                # reference joint-logP ESS rate
}

BASE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(BASE, "tests", "data")


def build_gtrg4(n_tips, n_patterns, dtype):
    import jax.numpy as jnp

    from physher_tpu.models.clock import StrictClock
    from physher_tpu.models.sitemodel import GammaSiteModel
    from physher_tpu.models.substitution import GTR
    from physher_tpu.models.treelikelihood import TreeLikelihood
    from physher_tpu.trees.timetree import TimeTreeData
    from physher_tpu.utils.synthetic import balanced_topology, random_sitepattern

    topo = balanced_topology(n_tips)
    sp = random_sitepattern(n_tips, n_patterns, seed=7)
    heights = np.zeros(topo.N)
    for k in range(topo.I):
        cs = topo.children[k, : topo.child_count[k]]
        heights[topo.T + k] = heights[cs].max() + 0.5
    td = TimeTreeData.from_heights(topo, heights)
    return TreeLikelihood(
        sp, topo, GTR(), GammaSiteModel(4),
        clock=StrictClock(topo.N, rate_init=1e-2), time_data=td,
        rescale=True, dtype=dtype,
    )


def timeit(fn, params, n=20, key=None):
    """Best-of-3 mean over n calls, cycling PERTURBED param dicts.

    Every call perturbs one scale-free positive parameter (``key``:
    default = first rate-like entry), so no call can be served from a
    cache of identical inputs; best-of-3 damps run-to-run variance.
    """
    import jax

    if key is None:
        # a key whose perturbation CHANGES the likelihood (scaling the
        # whole GTR rate vector is inert — Q is renormalized)
        for pref in ("bm.rate", "rate"):
            if pref in params:
                key = pref
                break
        else:
            key = next(k for k in params
                       if "distance" in k or "kappa" in k or "shape" in k)

    # per-process random salt: inputs never repeat across runs
    salt = np.random.default_rng(time.time_ns()).uniform(1e-6, 1e-4)

    def variant(j):
        return dict(params,
                    **{key: params[key] * (1.0 + salt * (j + 1))})

    def sync(out):
        # block each leaf and fetch one concrete value
        for leaf in jax.tree_util.tree_leaves(out):
            leaf.block_until_ready()
        return float(jax.tree_util.tree_leaves(out)[0].ravel()[0])

    sync(fn(variant(0)))
    best = 1e18
    for rep in range(3):
        # inputs unique across ALL calls of all repeats
        vs = [variant(1 + rep * n + i) for i in range(n)]
        t0 = time.perf_counter()
        outs = [fn(v) for v in vs]
        # device executions are serialized in order, so syncing the last
        # output covers the whole batch
        sync(outs[-1])
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def sustained(fn_raw, params, *, n: int = 32, key=None):
    """Sustained per-evaluation seconds: ``n`` PERTURBED evaluations of
    ``fn_raw(params)`` chained through one ``lax.scan`` dispatch, best of 3.

    Real consumers (Adam/L-BFGS/MCMC loops) run many evaluations per
    dispatch via scan, so sustained throughput is the deployment number;
    the dispatch-inclusive single-call time is reported separately.

    Anti-cache discipline carries over from ``timeit``: every scan
    iteration and every repeat perturbs one likelihood-changing parameter
    with a fresh per-process salt, and ALL outputs (value and every
    gradient leaf) are reduced into the scan carry so XLA cannot
    dead-code-eliminate the gradient work.
    """
    import jax
    import jax.numpy as jnp

    if key is None:
        for pref in ("bm.rate", "rate"):
            if pref in params:
                key = pref
                break
        else:
            key = next(k for k in params
                       if "distance" in k or "kappa" in k or "shape" in k)

    salt = np.random.default_rng(time.time_ns()).uniform(1e-6, 1e-4)

    @jax.jit
    def run(params, scales):
        def body(acc, s):
            p = dict(params, **{key: params[key] * s})
            out = fn_raw(p)
            leaves = jax.tree_util.tree_leaves(out)
            acc = acc + sum(jnp.sum(l.astype(jnp.float32)) for l in leaves)
            return acc, None

        acc, _ = jax.lax.scan(body, jnp.float32(0.0), scales)
        return acc

    def scales_for(rep):
        idx = np.arange(1, n + 1) + rep * n
        return jnp.asarray(1.0 + salt * idx, dtype=jnp.float32)

    float(run(params, scales_for(99)))  # compile + warmup
    best = 1e18
    for rep in range(3):
        sc = scales_for(rep)
        t0 = time.perf_counter()
        float(run(params, sc))
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def measured_roofline(fn, params, *, label, extras, flops, bytes_,
                      n_patterns, calls: int = 8):
    """MEASURED device-op timing via a jax.profiler trace. Uses perturbed
    inputs per call; reports device-busy ms/call, kernel launches per call,
    the idle share, the top kernels, and achieved FLOP/s + GB/s against the
    workload's arithmetic (flops/bytes_ per evaluation)."""
    import tempfile

    from physher_tpu.utils.profiling import (
        trace_op_times, Roofline, detect_chip)

    key = None
    for pref in ("bm.rate", "rate"):
        if pref in params:
            key = pref
            break
    if key is None:
        key = next(k for k in params
                   if "distance" in k or "kappa" in k or "shape" in k)
    salt = np.random.default_rng(time.time_ns()).uniform(1e-6, 1e-4)
    variants = [(dict(params, **{key: params[key] * (1.0 + salt * (j + 1))}),)
                for j in range(calls)]
    with tempfile.TemporaryDirectory() as log_dir:
        ops = trace_op_times(fn, variants, log_dir=log_dir, top=4)
    per_call = ops.busy_s / calls
    rl = Roofline(float(flops), float(bytes_), per_call, detect_chip())
    extras[f"{label}_device_ms_per_call_measured"] = round(per_call * 1e3, 3)
    extras[f"{label}_launches_per_call"] = ops.n_ops / calls
    extras[f"{label}_device_idle_share"] = round(ops.idle_share, 4)
    extras[f"{label}_device_patterns_per_s"] = round(n_patterns / per_call, 1)
    extras[f"{label}_roofline_measured"] = rl.report()
    extras[f"{label}_top_ops_measured"] = "; ".join(
        f"{name.split('.')[0]}:{s / calls * 1e3:.2f}ms"
        for name, s, _ in ops.rows)


def bench_gtrg4(extras):
    import jax
    import jax.numpy as jnp

    n_patterns = 16384
    tlk = build_gtrg4(128, n_patterns, jnp.float32)
    params = tlk.param_space().init_params(dtype=jnp.float32)

    vg_raw = jax.value_and_grad(tlk.log_likelihood)
    dt_vg = sustained(vg_raw, params, n=128)
    vg = jax.jit(vg_raw)
    dt_vg_1 = timeit(vg, params)
    dt_f = sustained(tlk.log_likelihood, params, n=128)

    pps = n_patterns / dt_vg
    extras["gtrg4_value_grad_single_dispatch_ms"] = round(dt_vg_1 * 1e3, 2)
    extras["gtrg4_forward_patterns_per_s"] = round(n_patterns / dt_f, 1)
    extras["gtrg4_forward_vs_ref_cpu"] = round(
        n_patterns / dt_f / REF["gtrg4_forward"], 2)

    # measured roofline (profiler trace) + the modeled one for context
    flops = 127 * 4 * (2 * 2 * 16 * n_patterns + 4 * n_patterns) * 3
    byts = (128 * 4 * n_patterns * 4          # tips, pmats and site_log:
            + 255 * 4 * 16 * 4                # the floor with partials kept
            + n_patterns * 4) * 2             # on chip; x2 for backward
    try:
        measured_roofline(vg, params, label="gtrg4", extras=extras,
                          flops=flops, bytes_=byts, n_patterns=n_patterns)
    except Exception as e:  # pragma: no cover
        extras["gtrg4_roofline_measured"] = f"failed: {e}"
    try:
        from physher_tpu.utils.profiling import pruning_roofline, detect_chip

        rl = pruning_roofline(255, 4, 4, n_patterns, dt_vg,
                              chip=detect_chip(), with_gradient=True)
        extras["gtrg4_roofline_modeled"] = rl.report()
    except Exception as e:  # pragma: no cover
        extras["gtrg4_roofline_modeled"] = f"failed: {e}"
    return pps


def bench_wag(extras):
    import jax
    import jax.numpy as jnp

    from physher_tpu.models.sitemodel import GammaSiteModel
    from physher_tpu.models.protein import WAG
    from physher_tpu.models.treelikelihood import TreeLikelihood
    from physher_tpu.utils.synthetic import balanced_topology, random_sitepattern

    n_patterns = 8192
    topo = balanced_topology(64)
    sp = random_sitepattern(64, n_patterns, seed=9, datatype="aminoacid")
    tlk = TreeLikelihood(sp, topo, WAG(), GammaSiteModel(4), rescale=True,
                         dtype=jnp.float32)
    params = tlk.param_space().init_params(dtype=jnp.float32)
    vg_raw = jax.value_and_grad(tlk.log_likelihood)
    dt = sustained(vg_raw, params, n=32)
    dt_f = sustained(tlk.log_likelihood, params, n=32)
    extras["wag_g4_value_grad_patterns_per_s"] = round(n_patterns / dt, 1)
    extras["wag_g4_value_grad_vs_ref_cpu"] = round(
        n_patterns / dt / REF["wag_value_grad"], 2)
    extras["wag_g4_forward_vs_ref_cpu"] = round(
        n_patterns / dt_f / REF["wag_forward"], 2)
    S = 20
    flops = 63 * 4 * (2 * 2 * S * S * n_patterns + S * n_patterns) * 3
    byts = (127 * 4 * S * n_patterns * 4 * 2
            + 127 * 4 * S * S * 4) * 2
    try:
        measured_roofline(jax.jit(vg_raw), params, label="wag_g4",
                          extras=extras, flops=flops, bytes_=byts,
                          n_patterns=n_patterns, calls=6)
    except Exception as e:  # pragma: no cover
        extras["wag_g4_roofline_measured"] = f"failed: {e}"


def bench_codon(extras):
    import jax
    import jax.numpy as jnp

    from physher_tpu.models.codon import GY94
    from physher_tpu.models.treelikelihood import TreeLikelihood
    from physher_tpu.utils.synthetic import balanced_topology, random_sitepattern

    n_patterns = 4096
    topo = balanced_topology(32)
    sp = random_sitepattern(32, n_patterns, seed=5, datatype="codon")
    tlk = TreeLikelihood(sp, topo, GY94(fixed_freqs=True), rescale=True,
                         dtype=jnp.float32)
    params = tlk.param_space().init_params(dtype=jnp.float32)
    dt_f = sustained(tlk.log_likelihood, params, n=64)
    vg_raw = jax.value_and_grad(tlk.log_likelihood)
    dt = sustained(vg_raw, params, n=64)
    extras["codon_m0_forward_patterns_per_s"] = round(n_patterns / dt_f, 1)
    extras["codon_m0_forward_vs_ref_cpu"] = round(
        n_patterns / dt_f / REF["codon_forward"], 2)
    extras["codon_m0_value_grad_patterns_per_s"] = round(n_patterns / dt, 1)
    # the reference's only WORKING codon gradient is finite differences
    # (its analytic codon path is bit-rotted — see module docstring)
    extras["codon_m0_value_grad_vs_ref_cpu_fd"] = round(
        n_patterns / dt / REF["codon_value_grad_fd"], 1)
    S = 61
    flops = 31 * 1 * (2 * 2 * S * S * n_patterns + S * n_patterns) * 3
    byts = (63 * S * n_patterns * 4 * 2 + 63 * S * S * 4) * 2
    try:
        measured_roofline(jax.jit(vg_raw), params, label="codon_m0",
                          extras=extras, flops=flops, bytes_=byts,
                          n_patterns=n_patterns, calls=6)
    except Exception as e:  # pragma: no cover
        extras["codon_m0_roofline_measured"] = f"failed: {e}"


def bench_elbo(extras):
    """fluA ADVI on the reference's own config (JC69-time-ELBO.json,
    committed as tests/data/fluA-elbo.json): iterations/s for the chunked
    reparameterized-gradient loop, wall-clock to run the reference's
    10,000-iteration schedule, and the converged ELBO vs the reference
    binary's optimum (tests/data/goldens/fluA_elbo.json)."""
    import jax
    import jax.numpy as jnp

    from physher_tpu.config.builder import build_config, load_json
    from physher_tpu.inference import vb as vb_mod

    cfg = load_json(os.path.join(DATA, "fluA-elbo.json"))
    ctx, actions = build_config(cfg, base_dir=DATA)
    vh = ctx.objects["varnormal"]
    eta = float(actions[0].get("eta", 0.1))

    # compile_s includes trace+lowering every process pays; XLA executables
    # additionally persist across processes (physher_tpu enables a
    # persistent compilation cache) — report which case this run hit
    cache_dir = jax.config.jax_compilation_cache_dir
    extras["fluA_elbo_compile_cache_warm"] = bool(
        cache_dir and os.path.isdir(cache_dir) and os.listdir(cache_dir))

    # throughput: 1000 iterations, 100-step scan chunks (dispatch latency
    # dominates this 238-pattern model otherwise), no early stop
    t0 = time.perf_counter()
    vb_mod.fit(vh.family, jax.random.PRNGKey(0), steps=100,
               learning_rate=eta, chunk=100, tol=0.0, elbo_every=10**9)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vb_mod.fit(vh.family, jax.random.PRNGKey(1), steps=1000,
               learning_rate=eta, chunk=100, tol=0.0, elbo_every=10**9)
    dt = (time.perf_counter() - t0) / 1000
    extras["fluA_elbo_iters_per_s"] = round(1.0 / dt, 1)
    extras["fluA_elbo_10000iter_wall_s"] = round(10000 * dt, 3)
    extras["fluA_elbo_vs_ref_cpu"] = round(
        (1.0 / dt) / REF["elbo_iters_per_s"], 2)
    extras["fluA_elbo_compile_s"] = round(compile_s, 1)
    # end-to-end on the reference's own 10k-iteration schedule, INCLUDING
    # one-time compile (the reference binary's 8 s includes its startup)
    extras["fluA_elbo_end_to_end_10k_s"] = round(compile_s + 10000 * dt, 2)
    extras["fluA_elbo_end_to_end_vs_ref"] = round(
        8.0 / (compile_s + 10000 * dt), 2)

    # convergence: same schedule as the reference (eta/sqrt(t) Adam)
    res = vb_mod.fit(vh.family, jax.random.PRNGKey(2), steps=6000,
                     learning_rate=eta, chunk=100, tol=1e-5)
    elbo = float(vh.family.elbo(res.vparams, jax.random.PRNGKey(123), 2000))
    extras["fluA_elbo_final"] = round(elbo, 2)
    extras["fluA_elbo_vs_ref_final_nats"] = round(
        elbo - REF["elbo_final"], 2)


def bench_mcmc(extras):
    """Batched-chain MCMC throughput on the fluA time-tree model, swept
    over chain counts (the reference runs ONE chain; its end-to-end rate
    on its own fluA HKY-MCMC config is 10,342 proposals/s — module
    docstring). Chains vectorize through the level-array XLA engine."""
    import jax
    import jax.numpy as jnp

    from physher_tpu.config.builder import build_config, load_json
    from physher_tpu.inference.mcmc import MCMC

    cfg = load_json(os.path.join(DATA, "jc69-time.json"))
    ctx, _ = build_config(cfg, base_dir=DATA)
    tlk = ctx.objects["treelikelihood"]
    space = tlk.param_space()
    params = space.init_params(dtype=jnp.float32)
    key = jax.random.PRNGKey(1)

    best = 0.0
    # ONE sampler instance: compiled chunk kernels cache on the instance
    # (per shape), so the sweep and repeats measure sampling, not XLA
    # recompilation (the r4 numbers were mostly compile time)
    mcmc = MCMC(space, tlk.log_likelihood)
    for n_chains, n_iter in ((1, 8192), (64, 512), (512, 512), (4096, 256),
                             (8192, 256)):

        def run(seed):
            # distinct seed per run: no two runs repeat their inputs
            return mcmc.run(jax.random.PRNGKey(seed), params,
                            n_iter=n_iter, every=n_iter, n_chains=n_chains)

        try:
            run(0)  # compile + warmup (same scan shape as the timed runs)
            dt = 1e18
            for rep in range(3):
                t0 = time.perf_counter()
                run(rep + 1)
                dt = min(dt, time.perf_counter() - t0)
        except Exception as e:  # e.g. HBM OOM at extreme chain counts
            extras[f"mcmc_{n_chains}chain_proposals_per_s"] = \
                f"failed: {type(e).__name__}"
            continue
        per_s = n_iter * n_chains / dt
        extras[f"mcmc_{n_chains}chain_proposals_per_s"] = round(per_s, 1)
        best = max(best, per_s)
    extras["mcmc_vs_ref_cpu_end_to_end"] = round(
        best / REF["mcmc_proposals_per_s"], 2)
    extras["mcmc_vs_ref_cpu_floor"] = round(
        best / REF["timetree_logp_per_s"], 2)

    # ESS/s: throughput is not worth anything if the chains don't mix —
    # report effective samples per second of the log-posterior across a
    # 512-chain run (64 chains' traces Geyer-ESS'd on host, scaled by
    # chain count) plus split-R-hat over the full batch (round-4 review
    # ask; utilities: utils/stats.py, matching the reference's single
    # long chain at 10,342 raw proposals/s)
    from physher_tpu.utils.stats import effective_sample_size, split_r_hat

    n_chains, n_iter, every, burn = 512, 16384, 32, 4096
    mcmc.run(jax.random.PRNGKey(0), params, n_iter=256, every=16,
             n_chains=n_chains, burnin=64)  # compile both chunk shapes
    t0 = time.perf_counter()
    res = mcmc.run(jax.random.PRNGKey(9), params, n_iter=n_iter,
                   every=every, n_chains=n_chains, burnin=burn,
                   init_jitter=0.05)
    wall = time.perf_counter() - t0
    lps = res.log_posterior  # [S, C]
    ess_per_chain = [effective_sample_size(lps[:, c]) for c in range(64)]
    total_ess = float(np.mean(ess_per_chain)) * n_chains
    extras["mcmc_ess_per_s"] = round(total_ess / wall, 1)
    extras["mcmc_ess_vs_ref_cpu"] = round(
        total_ess / wall / REF["mcmc_ess_per_s"], 1)
    extras["mcmc_split_rhat_logpost"] = round(split_r_hat(lps.T), 4)
    extras["mcmc_ess_run"] = (
        f"{n_chains} chains x {n_iter} it (burnin {burn}, thin {every}) "
        f"in {wall:.1f} s")


def bench_treemcmc(extras):
    """Device-side topology MCMC (BatchedTreeMCMC): NNI as index edits +
    per-proposal postorder recomputation inside a vmapped-chain jitted
    scan — vs the reference's single-chain host loop with incremental
    recompute (10,342 proposals/s on its own fluA HKY-MCMC config; the
    round-4 host-surgery TreeMCMC was proposal-latency-bound)."""
    import jax
    import jax.numpy as jnp

    from physher_tpu.data.sitepattern import SitePattern
    from physher_tpu.inference.treemcmc import BatchedTreeMCMC
    from physher_tpu.io.seqio import read_alignment
    from physher_tpu.models.substitution import JC69
    from physher_tpu.models.treelikelihood import TreeLikelihood
    from physher_tpu.data.distance import distance_matrix
    from physher_tpu.trees.build import nj

    aln = read_alignment(os.path.join(DATA, "fluA.fa"))
    sp = SitePattern.from_alignment(aln)
    topo, dist = nj(sp.taxa, distance_matrix(sp))
    tlk = TreeLikelihood(sp, topo, JC69(), distances_init=dist[: topo.N - 1],
                         dtype=jnp.float32)
    tm = BatchedTreeMCMC(tlk)
    # full re-evaluation per proposal (scales to many chains) and the
    # incremental partials-as-state sampler (O(depth) updates per
    # proposal; the latency-oriented path — the device analog of the
    # reference's store/restore + incremental recompute)
    for inc, sweeps in ((False, ((64, 256), (512, 128))),
                        (True, ((8, 512), (64, 256)))):
        for n_chains, n_iter in sweeps:
            tm.run(jax.random.PRNGKey(0), n_iter=n_iter, every=n_iter,
                   n_chains=n_chains, incremental=inc)  # compile + warmup
            dt = 1e18
            for rep in range(3):
                t0 = time.perf_counter()
                tm.run(jax.random.PRNGKey(rep + 1), n_iter=n_iter,
                       every=n_iter, n_chains=n_chains, incremental=inc)
                dt = min(dt, time.perf_counter() - t0)
            tag = "incr_" if inc else ""
            extras[f"treemcmc_{tag}{n_chains}chain_proposals_per_s"] = \
                round(n_iter * n_chains / dt, 1)


def main():
    import jax
    import jax.numpy as jnp  # noqa: F401

    extras = {"device": str(jax.devices()[0])}
    pps = bench_gtrg4(extras)
    for name, fn in (("wag", bench_wag), ("codon", bench_codon),
                     ("elbo", bench_elbo), ("mcmc", bench_mcmc),
                     ("treemcmc", bench_treemcmc)):
        try:
            fn(extras)
        except Exception as e:  # keep the primary metric alive
            extras[f"{name}_error"] = f"{type(e).__name__}: {e}"

    result = {
        "metric": "site-patterns/s/device (GTR+G pruning)",
        "value": round(pps, 1),
        "unit": "patterns/s (value+grad, 128 taxa, Gamma4)",
        "vs_baseline": round(pps / REF["gtrg4_value_grad"], 2),
        "extras": extras,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
