"""physher-tpu: a JAX/XLA phylogenetic inference framework for GPUs.

A from-scratch rebuild of the capabilities of 4ment/physher (maximum-likelihood
and Bayesian phylogenetics: tree likelihoods over nucleotide/amino-acid/codon
substitution models, clock and coalescent models, ML / MCMC / variational /
marginal-likelihood estimators) as one jittable JAX program:

- the compute path is pure JAX (jit/vmap/grad); the pruning sweep is a
  level-batched einsum schedule that XLA compiles for the device
  (ops/pruning.py),
- site patterns shard data-parallel over a ``jax.sharding.Mesh`` with
  all-reduces for log-likelihoods and gradients (parallel/mesh.py),
- models are pure functions of parameter pytrees (no listener graphs); the
  whole likelihood is recomputed inside one fused jitted function.

Precision policy: f32 matmuls run at full float32 precision (below);
reference-exact golden parity needs float64, which the CPU and the GPU both
run. Call :func:`enable_x64` (or set ``PHYSHER_TPU_X64=1``) before touching
jax arrays to run the f64 path.
"""

import os

__version__ = "0.1.0"

# Default matmul precision "highest": full float32 products. Below it, XLA may
# run f32 matmuls with reduced-precision operands: TF32 on the GPU, which on
# an H100 moved the f32 GTR+Gamma4 fluA logP by 1.9 units (4.6e-4 relative)
# where full f32 errs by 0.03. A likelihood framework cannot silently lose
# three digits: sums of thousands of log terms, MCMC acceptance ratios, and
# quasi-Newton curvature all amplify it.
import jax as _jax

if _jax.config.jax_default_matmul_precision is None:
    _jax.config.update("jax_default_matmul_precision", "highest")


def compile_cache_dir() -> str:
    """Persistent XLA compile-cache directory: ``$JAX_COMPILATION_CACHE_DIR``
    when set, else ``.jax_cache`` at the root of the checkout (a fixed path:
    the path is part of the cache key)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.abspath(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     ".jax_cache"))


# Persistent XLA compilation cache: phylogenetic models recompile the same
# executables across processes (CLI runs, MCMC restarts), and the reference
# binary has no compile step, so fresh-process parity demands the cache. Opt
# out with PHYSHER_TPU_NO_COMPILE_CACHE=1. CPU-only processes (tests, golden
# parity) skip it: XLA:CPU AOT entries pin host ISA features and loading them
# on a different host risks SIGILL.
if (os.environ.get("PHYSHER_TPU_NO_COMPILE_CACHE", "0") != "1"
        and os.environ.get("JAX_PLATFORMS", "").lower() != "cpu"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def enable_x64(enable: bool = True) -> None:
    """Enable float64 computation globally (required for golden-value parity)."""
    import jax

    jax.config.update("jax_enable_x64", enable)


if os.environ.get("PHYSHER_TPU_X64", "0") == "1":
    enable_x64()


def default_dtype():
    """The default floating dtype under the current jax x64 setting."""
    import jax.numpy as jnp

    return jnp.zeros(0).dtype
