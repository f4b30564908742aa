#!/usr/bin/env python3
"""End-to-end smoke test of physher-tpu on an NVIDIA GPU.

Drives the program's main path once, in one process, through the entry
points users call, and checks every result against the repository's own
references:

  (a) device: the card, its power limit, the compile cache;
  (b) f64 goldens on the card (fluA JC69 time tree, GTR+Gamma4 fluA);
  (c) f32 on the card: the same goldens, the 128-taxon x 16,384-pattern
      GTR+Gamma4 value+grad against f64, and 5 Adam steps on it;
  (d) the CLI on tests/data/jc69-time.json and tests/data/fluA-elbo.json;
  (e) the samplers: 512-chain MCMC, 64-chain tree-MCMC (full, incremental).

Run from the root of a checkout:

    python3 chip_smoke.py              # one GPU, phases (a)-(e)
    python3 chip_smoke.py --four-gpus  # the pattern-sharded path on 4 GPUs

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``. Any failed phase
raises, and the script exits non-zero without printing it. Without a GPU it
exits non-zero before running anything.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")

# reference goldens (tests/test_jc69_time_golden.py, tests/data/goldens/)
JC69_LOGP = -4777.616349713985
JC69_LOGP_JAC = -4786.867701371271
JC69_RATE_GRAD = 328017.6732813406
F64_RTOL = 1e-8
# jc69-time.json through the CLI in f64: the CPU optimum pinned by
# tests/test_cli_integration.py; the config's optimizer stops at precision
# 0.001, so the optimum is pinned to that
JC69_META_OPTIMUM = -4341.059554
JC69_META_ATOL = 1e-3
# f32 tolerances. A full-f32 pass errs on fluA by ~1e-5 relative (f32
# eigendecomposition, exponentials and the 238-pattern sum); one TF32 pass
# (10-bit mantissa, ~5e-4 relative per product) errs by ~1e-4 relative or
# more, so 5e-5 tells the two apart.
F32_LOGP_RTOL = 5e-5
# gradients: relative error of the whole gradient vector (2-norm), same
# margin over full f32
F32_GRAD_RTOL = 5e-4
SHARD_F64_RTOL = 1e-10
# bench.py's flagship GTR+Gamma4 time tree: taxa x patterns
FLAGSHIP = (128, 16384)

PHASES = ("device", "f64_goldens", "f32", "config", "samplers")
FOUR_GPU_PHASES = ("four_gpus",)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the pattern-sharded path on 4 GPUs, "
                         "against the same model on one GPU")
    return ap.parse_args(argv)


def select_phases(args) -> tuple:
    return FOUR_GPU_PHASES if args.four_gpus else PHASES


def parse_smi_line(line: str) -> tuple[str, str]:
    """(name, power limit) from one line of ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader``."""
    name, _, limit = line.strip().rpartition(",")
    if not name or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line {line!r}")
    return name.strip(), limit.strip()


def read_card() -> str:
    """The first card's ``name, power.limit`` line, as nvidia-smi prints
    it (checked to parse)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    line = out.strip().splitlines()[0].strip()
    parse_smi_line(line)
    return line


def require_gpu(devices, count: int = 1) -> None:
    """Refuse anything but ``count`` or more GPUs (no CPU fallback)."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise RuntimeError(f"no GPU: JAX's default device is {kind}")
    if len(devices) < count:
        raise RuntimeError(f"needs {count} GPUs, JAX sees {len(devices)}")


def cache_entries(path) -> int:
    return len(os.listdir(path)) if path and os.path.isdir(path) else 0


class Smoke:
    def __init__(self, card: str):
        self.card = card

    def log(self, msg: str) -> None:
        print(msg, flush=True)

    def timed(self, label: str, t0: float) -> None:
        self.log(f"  {label}: {time.perf_counter() - t0:.3f} s [{self.card}]")

    @staticmethod
    def check_rel(label, got, want, rtol):
        rel = abs(got - want) / abs(want)
        print(f"  {label}: {got!r} vs {want!r} (rel {rel:.3e}, "
              f"tol {rtol:g})", flush=True)
        if not rel <= rtol:
            raise AssertionError(f"{label}: rel error {rel:.3e} > {rtol:g}")

    # -- models ------------------------------------------------------------

    @staticmethod
    def jc69_model(dtype):
        """The reference's dated fluA JC69 model (tests/data/jc69-time.json
        tree, strict clock at 1e-3)."""
        from physher_tpu.data.sitepattern import SitePattern
        from physher_tpu.io.seqio import read_alignment
        from physher_tpu.io.treeio import read_newick
        from physher_tpu.models.clock import StrictClock
        from physher_tpu.models.substitution import JC69
        from physher_tpu.models.treelikelihood import TreeLikelihood
        from physher_tpu.trees.timetree import TimeTreeData

        with open(os.path.join(DATA, "jc69-time.json")) as fh:
            tree = json.load(fh)["model"]["tree"]
        topo, dist = read_newick(tree["newick"])
        td = TimeTreeData.from_dated_tree(topo, dist, tree["dates"])
        sp = SitePattern.from_alignment(
            read_alignment(os.path.join(DATA, "fluA.fa")))
        return TreeLikelihood(sp, topo, JC69(),
                              clock=StrictClock(topo.N, rate_init=1e-3),
                              time_data=td, tipstates=True, dtype=dtype)

    @staticmethod
    def gtrg4_fluA_model(dtype):
        """GTR+Gamma4 on fluA with the reference oracle's golden logP."""
        from physher_tpu.config.builder import build_config
        from physher_tpu.models.treelikelihood import TreeLikelihood

        with open(os.path.join(DATA, "goldens", "gtrg4_fluA.json")) as fh:
            cfg = json.load(fh)
        ctx, _ = build_config(cfg, base_dir=DATA)
        t = ctx.objects["treelikelihood"]
        if dtype is not None:
            t = TreeLikelihood(
                t.sp, t.topo, t.subst, t.site_model, clock=t.clock,
                time_data=t.time_data, distances_init=t.distances_init,
                tipstates=True, prefix=t.prefix, dtype=dtype)
        with open(os.path.join(DATA, "goldens", "gtrg4_fluA.txt")) as fh:
            logp = next(float(ln.split()[1]) for ln in fh
                        if ln.startswith("logP "))
        return t, logp

    @staticmethod
    def flagship(dtype):
        """bench.py's GTR+Gamma4 time tree, 128 taxa x 16,384 patterns."""
        sys.path.insert(0, ROOT)
        from bench import build_gtrg4

        return build_gtrg4(*FLAGSHIP, dtype)

    # -- phases ------------------------------------------------------------

    def device(self):
        import jax

        self.log(f"  card: {self.card}")
        self.log(f"  jax {jax.__version__}: {jax.devices()}")
        cache = jax.config.jax_compilation_cache_dir
        self.log(f"  compile cache: {cache} "
                 f"({cache_entries(cache)} entries at start)")

    def jc69_goldens(self, dtype, rtol, grad_rtol):
        import jax

        tlk = self.jc69_model(dtype)
        params = tlk.param_space().init_params(dtype=dtype)
        t0 = time.perf_counter()
        logp = float(jax.jit(tlk.log_likelihood_only)(params))
        logp_jac = float(jax.jit(
            lambda p: tlk.log_likelihood_only(p) + tlk.log_jacobian(p))(
                params))
        g = float(jax.jit(jax.grad(tlk.log_likelihood_only))(params)["rate"])
        self.timed("jc69-time logP, logP+jac, grad (with compile)", t0)
        self.check_rel("jc69-time logP", logp, JC69_LOGP, rtol)
        self.check_rel("jc69-time logP + ratio log-Jacobian", logp_jac,
                       JC69_LOGP_JAC, rtol)
        self.check_rel("jc69-time d logP / d rate", g, JC69_RATE_GRAD,
                       grad_rtol)

    def gtrg4_golden(self, dtype, rtol):
        import jax

        tlk, gold = self.gtrg4_fluA_model(dtype)
        params = tlk.param_space().init_params(dtype=dtype)
        t0 = time.perf_counter()
        logp = float(jax.jit(tlk.log_likelihood)(params))
        self.timed("GTR+G4 fluA logP (with compile)", t0)
        self.check_rel("GTR+G4 fluA logP", logp, gold, rtol)

    def f64_goldens(self):
        import jax

        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        self.jc69_goldens(jnp.float64, F64_RTOL, F64_RTOL)
        self.gtrg4_golden(jnp.float64, F64_RTOL)

    @staticmethod
    def value_grad(tlk, params):
        import jax
        import numpy as np

        v, g = jax.jit(jax.value_and_grad(tlk.log_likelihood))(params)
        flat = np.concatenate([np.ravel(np.asarray(g[k], np.float64))
                               for k in sorted(g)])
        return float(v), flat

    def check_grad(self, label, got, want, rtol):
        import numpy as np

        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        self.log(f"  {label}: gradient rel 2-norm error {rel:.3e} "
                 f"(tol {rtol:g})")
        if not np.all(np.isfinite(got)) or not rel <= rtol:
            raise AssertionError(f"{label}: gradient rel error {rel:.3e}")

    def f32(self):
        import jax
        import numpy as np

        # the f64 reference of the flagship first, then the f32 path as
        # users run it (x64 off)
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        t0 = time.perf_counter()
        t64 = self.flagship(jnp.float64)
        v64, g64 = self.value_grad(t64, t64.param_space().init_params())
        self.timed("flagship f64 value+grad (with compile)", t0)
        del t64

        jax.config.update("jax_enable_x64", False)
        self.jc69_goldens(jnp.float32, F32_LOGP_RTOL, F32_GRAD_RTOL)
        self.gtrg4_golden(jnp.float32, F32_LOGP_RTOL)

        t0 = time.perf_counter()
        tlk = self.flagship(jnp.float32)
        space = tlk.param_space()
        params = space.init_params(dtype=jnp.float32)
        v32, g32 = self.value_grad(tlk, params)
        self.timed("flagship f32 value+grad (with compile)", t0)
        self.check_rel("flagship f32 logP vs f64", v32, v64, F32_LOGP_RTOL)
        self.check_grad("flagship f32 vs f64", g32, g64, F32_GRAD_RTOL)

        from physher_tpu.utils.optim import adam

        opt = adam(1e-2)

        def loss(u):
            return -tlk.log_likelihood(space.constrain(u))

        @jax.jit
        def step(u, state):
            val, grads = jax.value_and_grad(loss)(u)
            upd, state = opt.update(grads, state, u)
            return jax.tree.map(lambda a, b: a + b, u, upd), state, val

        u = space.unconstrain(params)
        state = opt.init(u)
        losses = []
        t0 = time.perf_counter()
        for _ in range(5):
            u, state, val = step(u, state)
            losses.append(float(val))
        final = float(jax.jit(loss)(u))
        self.timed("5 Adam steps on the flagship (with compile)", t0)
        self.log(f"  Adam losses {losses} -> {final}")
        if not (np.all(np.isfinite(losses)) and np.isfinite(final)
                and final < losses[0]):
            raise AssertionError(f"Adam did not lower the loss: {losses}")

    def run_cli(self, cfg_name, argv, workdir):
        """physher_tpu.cli.main in this process; returns its stdout."""
        from physher_tpu import cli

        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.chdir(workdir), contextlib.redirect_stdout(buf):
            rc = cli.main([os.path.join(workdir, cfg_name), *argv])
        self.timed(f"physher-tpu {cfg_name} {' '.join(argv)}", t0)
        out = buf.getvalue()
        tail = [ln for ln in out.splitlines() if ln.strip()][-3:]
        for ln in tail:
            self.log(f"    | {ln[:200]}")
        if rc != 0:
            raise RuntimeError(f"{cfg_name}: exit code {rc}")
        return out

    @staticmethod
    def workdir(tmp):
        """Copy the configs and the data they name into ``tmp``, so config
        outputs (checkpoints, logs) land there and not in the checkout."""
        for f in ("jc69-time.json", "fluA-elbo.json", "fluA.fa",
                  "fluA-rooted.nxs"):
            shutil.copy(os.path.join(DATA, f), tmp)
        return tmp

    @staticmethod
    def max_logl(out: str) -> float:
        m = re.search(r"Maximum log likelihood: (-?\d+\.\d+)", out)
        if not m:
            raise AssertionError("no 'Maximum log likelihood' line")
        return float(m.group(1))

    def config(self):
        with open(os.path.join(DATA, "goldens", "fluA_elbo.json")) as fh:
            elbo_gold = json.load(fh)
        with tempfile.TemporaryDirectory() as tmp:
            wd = self.workdir(tmp)
            out = self.run_cli("jc69-time.json", ["--f64"], wd)
            logl = self.max_logl(out)
            self.log(f"  jc69-time optimum {logl!r} vs CPU "
                     f"{JC69_META_OPTIMUM!r} (atol {JC69_META_ATOL:g})")
            if not abs(logl - JC69_META_OPTIMUM) <= JC69_META_ATOL:
                raise AssertionError("jc69-time optimum differs from CPU")

            out = self.run_cli("fluA-elbo.json", [], wd)
            m = re.search(r"ELBO: (-?\d+\.\d+) \((\d+) iterations\)", out)
            if not m:
                raise AssertionError("no ELBO line")
            elbo = float(m.group(1))
            ref, tol = elbo_gold["reference_elbo"], elbo_gold["tolerance_nats"]
            self.log(f"  fluA ELBO {elbo!r} after {m.group(2)} iterations "
                     f"vs reference {ref} (tol {tol} nats)")
            if not abs(elbo - ref) <= tol:
                raise AssertionError("fluA ELBO outside the reference band")

    def samplers(self):
        import jax
        import numpy as np

        jax.config.update("jax_enable_x64", False)
        import jax.numpy as jnp

        from physher_tpu.config.builder import build_config, load_json
        from physher_tpu.inference.mcmc import MCMC

        ctx, _ = build_config(load_json(os.path.join(DATA, "jc69-time.json")),
                              base_dir=DATA)
        tlk = ctx.objects["treelikelihood"]
        space = tlk.param_space()
        mcmc = MCMC(space, tlk.log_likelihood)
        t0 = time.perf_counter()
        res = mcmc.run(jax.random.PRNGKey(1),
                       space.init_params(dtype=jnp.float32), n_iter=256,
                       every=64, n_chains=512)
        self.timed("MCMC 512 chains x 256 iterations (with compile)", t0)
        acc = np.asarray(res.acceptance)
        self.log(f"  MCMC log-posterior range "
                 f"[{res.log_posterior.min():.3f}, "
                 f"{res.log_posterior.max():.3f}], acceptance {acc}")
        if not (np.all(np.isfinite(res.log_posterior))
                and np.all((acc > 0) & (acc < 1))):
            raise AssertionError("MCMC: non-finite or degenerate chains")

        for incremental, dtype in ((False, jnp.float32), (True, jnp.float32),
                                   (True, jnp.float64)):
            self.tree_mcmc(incremental, dtype)

    def tree_mcmc(self, incremental, dtype):
        """BatchedTreeMCMC on fluA (NJ start, JC69), 64 chains. In f64 the
        incremental sampler's carried log-posterior must equal a
        from-scratch evaluation of each chain's final state
        (tests/test_treemcmc.py::test_incremental_recompute_matches_full)."""
        import jax
        import numpy as np

        jax.config.update("jax_enable_x64", np.dtype(dtype) == np.float64)
        import jax.numpy as jnp

        from physher_tpu.data.distance import distance_matrix
        from physher_tpu.data.sitepattern import SitePattern
        from physher_tpu.inference.treemcmc import BatchedTreeMCMC
        from physher_tpu.io.seqio import read_alignment
        from physher_tpu.models.substitution import JC69
        from physher_tpu.models.treelikelihood import TreeLikelihood
        from physher_tpu.ops.dynamic_pruning import (
            postorder_from_children, tree_loglik_dynamic_ordered)
        from physher_tpu.trees.build import nj

        sp = SitePattern.from_alignment(
            read_alignment(os.path.join(DATA, "fluA.fa")))
        topo, dist = nj(sp.taxa, distance_matrix(sp))
        tlk = TreeLikelihood(sp, topo, JC69(),
                             distances_init=dist[: topo.N - 1], dtype=dtype)
        tm = BatchedTreeMCMC(tlk)
        n_chains = 64
        t0 = time.perf_counter()
        res = tm.run(jax.random.PRNGKey(3), n_iter=256, every=128,
                     n_chains=n_chains, incremental=incremental)
        mode = "incremental" if incremental else "full"
        self.timed(f"tree-MCMC {mode} {np.dtype(dtype).name} 64 chains x 256 "
                   "iterations (with compile)", t0)
        acc = res["acceptance"]
        self.log(f"  tree-MCMC {mode}: acceptance {acc}")
        # JC69 has no free substitution parameters, so only the NNI and
        # branch-length moves propose
        if not (np.all(np.isfinite(res["logp"]))
                and all(0.0 < acc[k] < 1.0 for k in ("nni", "branch"))):
            raise AssertionError(f"tree-MCMC {mode}: bad chains")
        if not (incremental and np.dtype(dtype) == np.float64):
            return
        tp = jnp.asarray(tlk.tip_partials)
        w = jnp.asarray(tlk.weights)
        freqs = tlk.subst.frequencies({}).astype(w.dtype)
        props = jnp.ones(1, w.dtype)
        rate = tm.bl_prior_rate

        @jax.jit
        def full(ch, bl):
            pm = tlk.subst.p_t(
                {}, jnp.clip(bl, 0.0, None)[:, None]).astype(w.dtype)
            order = postorder_from_children(ch, tlk.topo.T)
            ll = tree_loglik_dynamic_ordered(
                tp, pm, ch, order, freqs, props, w, rescale=tlk.rescale)[0]
            n_br = bl.shape[0] - 1
            return ll + n_br * jnp.log(rate) - rate * jnp.sum(bl[:-1])

        worst = 0.0
        for b in range(n_chains):
            lp = float(full(jnp.asarray(res["children"][-1, b]),
                            jnp.asarray(res["bl"][-1, b])))
            worst = max(worst, abs(res["logp"][-1, b] - lp) / abs(lp))
        self.log(f"  incremental vs full recomputation, 64 chains: "
                 f"worst rel {worst:.3e} (tol {F64_RTOL:g})")
        if not worst <= F64_RTOL:
            raise AssertionError("incremental partials drifted from full")

    def four_gpus(self):
        """Patterns of the flagship sharded over 4 GPUs against one GPU,
        and jc69-time.json through the CLI with --devices 4 and --mesh 2x2
        against one GPU."""
        import jax

        from physher_tpu.parallel.mesh import (
            pattern_mesh, replicate, shard_tree_likelihood)

        self.device()
        for x64 in (True, False):
            jax.config.update("jax_enable_x64", x64)
            import jax.numpy as jnp

            dtype = jnp.float64 if x64 else jnp.float32
            one = self.flagship(dtype)
            params = one.param_space().init_params(dtype=dtype)
            t0 = time.perf_counter()
            v1, g1 = self.value_grad(one, params)
            self.timed(f"flagship {jnp.dtype(dtype).name} value+grad, "
                       "1 GPU (with compile)", t0)
            del one
            mesh = pattern_mesh(4)
            four = shard_tree_likelihood(self.flagship(dtype), mesh)
            t0 = time.perf_counter()
            v4, g4 = self.value_grad(four, replicate(mesh, params))
            self.timed(f"flagship {jnp.dtype(dtype).name} value+grad, "
                       "4 GPUs (with compile)", t0)
            rtol = SHARD_F64_RTOL if x64 else F32_LOGP_RTOL
            self.check_rel(f"4-GPU vs 1-GPU logP ({jnp.dtype(dtype).name})",
                           v4, v1, rtol)
            self.check_grad(f"4-GPU vs 1-GPU ({jnp.dtype(dtype).name})",
                            g4, g1, rtol if x64 else F32_GRAD_RTOL)
            del four

        with tempfile.TemporaryDirectory() as tmp:
            wd = self.workdir(tmp)
            base = self.max_logl(self.run_cli("jc69-time.json", ["--f64"], wd))
            for flags in (["--devices", "4"], ["--mesh", "2x2"]):
                got = self.max_logl(self.run_cli(
                    "jc69-time.json", ["--f64", *flags], wd))
                self.log(f"  jc69-time {' '.join(flags)}: {got!r} vs 1 GPU "
                         f"{base!r} (atol {JC69_META_ATOL:g})")
                if not abs(got - base) <= JC69_META_ATOL:
                    raise AssertionError(f"jc69-time {flags} differs")


def main(argv=None) -> int:
    args = parse_args(argv)
    phases = select_phases(args)
    import physher_tpu  # noqa: F401  (sets the precision and compile cache)
    import jax

    count = 4 if args.four_gpus else 1
    require_gpu(jax.devices(), count)
    smoke = Smoke(read_card())
    t_all = time.perf_counter()
    for name in phases:
        smoke.log(f"== phase {name}")
        t0 = time.perf_counter()
        getattr(smoke, name)()
        smoke.log(f"== phase {name} ok in {time.perf_counter() - t0:.3f} s "
                  f"[{smoke.card}]")
    cache = jax.config.jax_compilation_cache_dir
    smoke.log(f"compile cache: {cache} ({cache_entries(cache)} entries at "
              f"end); total {time.perf_counter() - t_all:.3f} s")
    print(smoke.card)
    dev = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
