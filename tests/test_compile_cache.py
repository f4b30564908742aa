"""Compile-cache placement and the default matmul precision."""

import os

import jax

import physher_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert physher_tpu.compile_cache_dir() == str(tmp_path)


def test_cache_dir_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert physher_tpu.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_default_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_default_matmul_precision_is_highest():
    assert jax.config.jax_default_matmul_precision == "highest"
    from physher_tpu.ops import pruning

    assert pruning.PRECISION == "highest"
