"""Profiling utilities and the physhpy-style config generator."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from physher_tpu.utils import profiling
from physher_tpu import configgen

H100 = "NVIDIA H100 80GB HBM3"


class TestProfiling:
    def test_time_jit(self):
        import jax

        f = jax.jit(lambda x: (x * 2).sum())
        t = profiling.time_jit(f, jnp.ones(1000), calls=5)
        assert t.compile_s > 0 and t.per_call_s > 0
        assert t.per_call_ms < t.compile_s * 1e3

    def test_roofline_math(self):
        r = profiling.pruning_roofline(137, 4, 4, 256, 1e-3, chip=H100)
        assert r.flops > 0 and r.bytes > 0
        assert r.bound() in ("compute", "memory")
        assert 0 <= r.fraction_of_peak() < 10
        assert "GFLOP" in r.report()

    def test_intensity_small_states_memory_bound(self):
        # 4-state pruning is memory-bound at f32 and f64 alike
        r = profiling.pruning_roofline(2000, 4, 4, 4096, 1e-3, chip=H100)
        assert r.bound() == "memory"

    def test_detect_chip(self, monkeypatch):
        import jax
        from types import SimpleNamespace

        # a device without published peaks (this CPU) is an error
        with pytest.raises(ValueError, match="no published peaks"):
            profiling.detect_chip()
        monkeypatch.setattr(jax, "devices", lambda *a: [
            SimpleNamespace(platform="gpu", device_kind=H100)])
        assert profiling.detect_chip() == H100


class TestConfiggen:
    def _args(self, cmd, extra=()):
        import io
        import contextlib
        import os

        data = os.path.join(os.path.dirname(__file__), "data")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            configgen.main([cmd, "-i", os.path.join(data, "tiny.fa"),
                            "-t", os.path.join(data, "goldens"),
                            *extra])
        return json.loads(out.getvalue())

    def test_optimize_schema(self, tmp_path):
        # need a real tree file; build one quickly
        import os

        from physher_tpu.io.seqio import read_alignment
        from physher_tpu.data.sitepattern import SitePattern
        from physher_tpu.data.distance import distance_matrix
        from physher_tpu.trees.build import nj
        from physher_tpu.io.treeio import write_newick

        data = os.path.join(os.path.dirname(__file__), "data")
        aln = read_alignment(os.path.join(data, "tiny.fa"))
        sp = SitePattern.from_alignment(aln)
        topo, d = nj(sp.taxa, distance_matrix(sp, "jc69"))
        tree = tmp_path / "t.nwk"
        tree.write_text(write_newick(topo, d))

        import io
        import contextlib

        for cmd, extra in [
            ("optimize", ["-m", "GTR", "-c", "4"]),
            ("advi", ["--clock", "strict", "--coalescent", "constant"]),
            ("mcmc", ["-m", "HKY", "--length", "100"]),
        ]:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                configgen.main([cmd, "-i", os.path.join(data, "tiny.fa"),
                                "-t", str(tree), *extra])
            cfg = json.loads(out.getvalue())
            assert "physher" in cfg and "model" in cfg
            # generated config must BUILD through the reference-schema
            # builder
            from physher_tpu.config.builder import build_config

            ctx, actions = build_config(cfg, base_dir=str(tmp_path))
            assert actions, cmd
