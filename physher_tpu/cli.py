"""physher-tpu CLI: run reference-format JSON configs.

Rebuild of the reference's main program (reference: src/physher.c:62-326):
parse the config, build the model graph, execute the ``physher`` action list.
Flags mirror the reference: ``--seed``, ``--dry`` (print resolved config),
``-c`` checkpoint restore. Extra flags: ``--platform``, ``--f64``,
``--devices``, ``--mesh``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="physher-tpu",
        description="phylogenetic inference on JAX devices "
                    "(physher-compatible JSON configs)")
    ap.add_argument("config", help="JSON config file")
    ap.add_argument("--seed", type=int, default=None,
                    help="random seed (overrides config init.seed)")
    ap.add_argument("--dry", action="store_true",
                    help="print the resolved config and exit")
    ap.add_argument("-c", "--checkpoint", default=None,
                    help="restore parameter values from a checkpoint CSV")
    ap.add_argument("--platform", default=None,
                    help="jax platform (cpu/gpu); default: jax's choice")
    ap.add_argument("--f64", action="store_true", default=None,
                    help="enable float64 (default on CPU; the GPU runs it "
                         "natively)")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard site patterns over N devices "
                         "(overrides config init.devices)")
    ap.add_argument("--mesh", default=None, metavar="CxP",
                    help="2-D device mesh 'chains x patterns', e.g. 2x4 "
                         "(overrides config init.mesh)")
    args = ap.parse_args(argv)

    # jax may already be imported (tests, pytest plugins) with its platform
    # fixed, so the JAX_PLATFORMS env var alone cannot reliably select one —
    # honor it (and --platform / PHYSHER_TPU_PLATFORM) via config.update.
    platform = (args.platform or os.environ.get("PHYSHER_TPU_PLATFORM")
                or os.environ.get("JAX_PLATFORMS"))
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    f64 = args.f64
    if f64 is None:
        f64 = jax.default_backend() == "cpu"
    jax.config.update("jax_enable_x64", bool(f64))

    from .config.builder import build_config, load_json, _prune

    cfg = load_json(args.config)

    if args.dry:
        json.dump(_prune(cfg), sys.stdout, indent=2)
        print()
        return 0

    t0 = time.time()
    base_dir = os.path.dirname(os.path.abspath(args.config))
    devices = None
    if args.mesh:
        c, p = args.mesh.lower().replace("x", " ").split()
        devices = {"chains": int(c), "patterns": int(p)}
    elif args.devices:
        devices = args.devices
    ctx, actions = build_config(cfg, base_dir=base_dir, devices=devices)
    seed = args.seed if args.seed is not None else getattr(ctx, "seed", 0)

    from .config.actions import Runner

    runner = Runner(ctx, seed=seed)
    if args.checkpoint and os.path.exists(args.checkpoint):
        from .inference.ml import load_checkpoint

        # seed the pool from the checkpoint over every model's parameters
        pool = {}
        for obj in ctx.objects.values():
            if hasattr(obj, "param_space"):
                pool.update(obj.param_space().init_params())
        runner.pool = dict(load_checkpoint(args.checkpoint, pool))
    runner.run(actions)
    print(f"Total runtime: {time.time() - t0:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
