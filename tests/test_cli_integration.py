"""End-to-end CLI integration: legacy argv front-end, JSON configs, loggers.

Reference parity: src/physher.c main flow, src/phyc/physhercmd.c argv
builder, logger/checkpoint outputs.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PHYSHER_TPU_PLATFORM": "cpu",
       "JAX_PLATFORMS": "cpu",
       "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


def run_cli(args, cwd=None):
    return subprocess.run([sys.executable, "-m", "physher_tpu.cli", *args],
                          capture_output=True, text=True, env=ENV, cwd=cwd,
                          timeout=500)


class TestLegacyCli:
    def test_dry_prints_valid_config(self):
        out = subprocess.run(
            [sys.executable, "-m", "physher_tpu.legacy_cli",
             "-i", os.path.join(DATA, "tiny.fa"), "-m", "GTR", "-c", "4",
             "-D", "nj", "--dry"],
            capture_output=True, text=True, env=ENV, timeout=120)
        assert out.returncode == 0, out.stderr
        cfg = json.loads(out.stdout)
        assert cfg["model"]["type"] == "treelikelihood"
        assert cfg["physher"][0]["algorithm"] == "meta"
        # the generated config builds
        from physher_tpu.config.builder import build_config

        ctx, actions = build_config(cfg, base_dir=DATA)
        assert actions


class TestJsonCli:
    def test_dry_flag(self, tmp_path):
        cfg = {"model": {"id": "x", "type": "parsimony",
                         "sitepattern": {"id": "p", "type": "sitepattern",
                                         "datatype": "nucleotide",
                                         "alignment": {"id": "a",
                                                       "type": "alignment",
                                                       "file": "tiny.fa"}},
                         "tree": {"id": "t", "type": "tree",
                                  "init": {"algorithm": "nj",
                                           "sitepattern": "&p"}}},
               "_comment": "pruned", "physher": []}
        f = tmp_path / "c.json"
        f.write_text(json.dumps(cfg))
        out = run_cli([str(f), "--dry"])
        assert out.returncode == 0, out.stderr
        resolved = json.loads(out.stdout)
        assert "_comment" not in resolved

    def test_optimizer_logger_checkpoint(self, tmp_path):
        # small adam run over tiny.fa writing a checkpoint + logger output
        ckpt = tmp_path / "ck.csv"
        cfg = {
            "model": {
                "id": "treelikelihood", "type": "treelikelihood",
                "sitepattern": {
                    "id": "patterns", "type": "sitepattern",
                    "datatype": "nucleotide",
                    "alignment": {"id": "seqs", "type": "alignment",
                                  "file": os.path.join(DATA, "tiny.fa")}},
                "sitemodel": {
                    "id": "sitemodel", "type": "sitemodel",
                    "substitutionmodel": {
                        "id": "sm", "type": "substitutionmodel",
                        "model": "jc69", "datatype": "nucleotide"}},
                "tree": {"id": "tree", "type": "tree",
                         "parameters": "tree.distances",
                         "init": {"algorithm": "nj",
                                  "sitepattern": "&patterns"}},
            },
            "physher": [
                {"id": "opt", "type": "optimizer", "algorithm": "sg",
                 "max": 60, "model": "&treelikelihood",
                 "checkpoint": str(ckpt)},
                {"id": "log", "type": "logger",
                 "models": "&treelikelihood"},
            ],
        }
        f = tmp_path / "c.json"
        f.write_text(json.dumps(cfg))
        out = run_cli([str(f)], cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr
        assert "Maximum log likelihood" in out.stdout
        assert ckpt.exists()
        # reference checkpoint format: name,value lines (checkpoint.c)
        lines = ckpt.read_text().strip().splitlines()
        assert all("," in ln for ln in lines)
        # restore path: -c flag
        out2 = run_cli([str(f), "-c", str(ckpt)], cwd=str(tmp_path))
        assert out2.returncode == 0, out2.stderr


class TestConfiggenRoundTrip:
    def test_mcmc_config_runs(self, tmp_path):
        from physher_tpu.io.seqio import read_alignment
        from physher_tpu.data.sitepattern import SitePattern
        from physher_tpu.data.distance import distance_matrix
        from physher_tpu.trees.build import nj
        from physher_tpu.io.treeio import write_newick

        aln = read_alignment(os.path.join(DATA, "tiny.fa"))
        sp = SitePattern.from_alignment(aln)
        topo, d = nj(sp.taxa, distance_matrix(sp, "jc69"))
        tree = tmp_path / "t.nwk"
        tree.write_text(write_newick(topo, d))
        gen = subprocess.run(
            [sys.executable, "-m", "physher_tpu.configgen", "mcmc",
             "-i", os.path.join(DATA, "tiny.fa"), "-t", str(tree),
             "--length", "600", "--every", "100", "-o",
             str(tmp_path / "run")],
            capture_output=True, text=True, env=ENV, timeout=120)
        assert gen.returncode == 0, gen.stderr
        cfgf = tmp_path / "m.json"
        cfgf.write_text(gen.stdout)
        out = run_cli([str(cfgf)], cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr
        assert "MCMC finished" in out.stdout
        # loggers wrote reference-format outputs
        log = tmp_path / "run.log"
        trees = tmp_path / "run.trees"
        assert log.exists() and trees.exists()
        header = log.read_text().splitlines()[0]
        assert "\t" in header or "," in header
        assert "tree" in trees.read_text().lower()


class TestSitewiseCpo:
    def test_sitewise_log_and_file_cpo(self, tmp_path):
        sw = tmp_path / "sitewise.log"
        cfg = {
            "model": {
                "id": "treelikelihood", "type": "treelikelihood",
                "sitepattern": {
                    "id": "patterns", "type": "sitepattern",
                    "datatype": "nucleotide",
                    "alignment": {"id": "seqs", "type": "alignment",
                                  "file": os.path.join(DATA, "tiny.fa")}},
                "sitemodel": {
                    "id": "sitemodel", "type": "sitemodel",
                    "substitutionmodel": {
                        "id": "sm", "type": "substitutionmodel",
                        "model": "jc69", "datatype": "nucleotide"}},
                "tree": {"id": "tree", "type": "tree",
                         "parameters": "tree.distances",
                         "init": {"algorithm": "nj",
                                  "sitepattern": "&patterns"}},
            },
            "physher": [
                {"id": "mcmc", "type": "mcmc", "model": "&treelikelihood",
                 "length": 500,
                 "log": [{"id": "sw", "type": "logger", "every": 100,
                          "sitewise": True, "file": str(sw),
                          "models": "&treelikelihood"}],
                 "operators": [{"id": "op", "type": "operator",
                                "algorithm": "scaler",
                                "x": "%tree.distances", "weight": 1}]},
                {"id": "cpo", "type": "cpo", "filename": str(sw)},
            ],
        }
        f = tmp_path / "c.json"
        f.write_text(json.dumps(cfg))
        out = run_cli([str(f)], cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr
        assert sw.exists()
        first = sw.read_text().splitlines()[0]
        assert first.startswith("#")     # reference weight-line format
        assert "LPML" in out.stdout


class TestTreeMcmcConfig:
    def test_nni_operator_routes_to_tree_mcmc(self, tmp_path):
        from physher_tpu.config.builder import build_config
        from physher_tpu.config.actions import Runner
        from physher_tpu.io.treeio import read_newick

        cfg = {
            "model": {
                "id": "treelikelihood", "type": "treelikelihood",
                "sitepattern": {
                    "id": "patterns", "type": "sitepattern",
                    "datatype": "nucleotide",
                    "alignment": {"id": "seqs", "type": "alignment",
                                  "file": os.path.join(DATA, "tiny.fa")}},
                "sitemodel": {
                    "id": "sitemodel", "type": "sitemodel",
                    "substitutionmodel": {
                        "id": "sm", "type": "substitutionmodel",
                        "model": "jc69", "datatype": "nucleotide"}},
                "tree": {"id": "tree", "type": "tree",
                         "parameters": "tree.distances",
                         "init": {"algorithm": "nj",
                                  "sitepattern": "&patterns"}},
            },
            "physher": [
                {"id": "mcmc", "type": "mcmc", "length": 600,
                 "model": "&treelikelihood",
                 "operators": [
                     {"id": "o1", "type": "operator", "algorithm": "nni",
                      "x": "&tree", "weight": 1},
                     {"id": "o2", "type": "operator", "algorithm": "scaler",
                      "x": "%tree.distances", "weight": 4}],
                 "log": [
                     {"id": "l1", "type": "logger", "every": 100,
                      "file": str(tmp_path / "chain.log")},
                     {"id": "l2", "type": "logger", "every": 100,
                      "file": str(tmp_path / "chain.trees"),
                      "models": "&tree"}]},
            ],
        }
        ctx, actions = build_config(cfg, base_dir=DATA)
        r = Runner(ctx, seed=1)
        res = r.run(actions)["mcmc"]
        assert 0 < res.acceptance["nni"] <= 1.0
        lines = (tmp_path / "chain.log").read_text().strip().split("\n")
        assert lines[0] == "state\tposterior"
        assert len(lines) == 7  # header + 600/100 samples
        trees = (tmp_path / "chain.trees").read_text().strip().split("\n")
        assert len(trees) == 6
        topo, _ = read_newick(trees[-1])
        assert topo.T == 10


    def test_batched_tree_mcmc_routes_from_config(self, tmp_path):
        """"chains" > 1 on an nni-operator mcmc node routes to the
        device-side BatchedTreeMCMC (NNI as index edits in a vmapped jitted
        scan) and still writes reference-format chain/tree logs."""
        from physher_tpu.config.builder import build_config
        from physher_tpu.config.actions import Runner
        from physher_tpu.io.treeio import read_newick

        cfg = {
            "model": {
                "id": "treelikelihood", "type": "treelikelihood",
                "sitepattern": {
                    "id": "patterns", "type": "sitepattern",
                    "datatype": "nucleotide",
                    "alignment": {"id": "seqs", "type": "alignment",
                                  "file": os.path.join(DATA, "tiny.fa")}},
                "sitemodel": {
                    "id": "sitemodel", "type": "sitemodel",
                    "substitutionmodel": {
                        "id": "sm", "type": "substitutionmodel",
                        "model": "jc69", "datatype": "nucleotide"}},
                "tree": {"id": "tree", "type": "tree",
                         "parameters": "tree.distances",
                         "init": {"algorithm": "nj",
                                  "sitepattern": "&patterns"}},
            },
            "physher": [
                {"id": "mcmc", "type": "mcmc", "length": 400, "chains": 4,
                 "incremental": True,
                 "model": "&treelikelihood",
                 "operators": [
                     {"id": "o1", "type": "operator", "algorithm": "nni",
                      "x": "&tree", "weight": 1},
                     {"id": "o2", "type": "operator", "algorithm": "scaler",
                      "x": "%tree.distances", "weight": 4}],
                 "log": [
                     {"id": "l1", "type": "logger", "every": 100,
                      "file": str(tmp_path / "chain.log")},
                     {"id": "l2", "type": "logger", "every": 100,
                      "file": str(tmp_path / "chain.trees"),
                      "models": "&tree"}]},
            ],
        }
        ctx, actions = build_config(cfg, base_dir=DATA)
        r = Runner(ctx, seed=1)
        res = r.run(actions)["mcmc"]
        assert res["children"].shape[1] == 4          # vmapped chains
        assert 0 < res["acceptance"]["nni"] <= 1.0
        lines = (tmp_path / "chain.log").read_text().strip().split("\n")
        assert lines[0] == "state\tposterior"
        assert len(lines) == 1 + res["logp"].shape[0]
        trees = (tmp_path / "chain.trees").read_text().strip().split("\n")
        assert len(trees) == res["logp"].shape[0]
        topo, dist = read_newick(trees[-1])
        assert topo.T == 10
        import numpy as np
        assert np.isfinite(dist[: topo.N - 1]).all()


class TestTimeTreeOptimizer:
    def test_jc69_time_meta_optimizer_finishes(self, data_dir):
        """The reference's own time-tree test config (jc69-time.json, meta +
        serial sub-optimizer, optimizer.c:154-210) must run through the CLI
        within CI time and improve on the initial logP.

        The meta schedule scopes optimization to the tree's height
        parameters (the serial sub-optimizer's target; clock rate stays at
        its init, as in the reference). Initial logP with the ratio-
        transform jacobian is -4786.8677 (tests/test_tree_likelihood.c:88);
        the scoped optimum is -4341.059554, pinned to the config's stopping
        precision (0.001); chip_smoke.py checks the GPU run against the
        same value. NB the reference's own run of this
        config is degenerate: serial Brent walks node->distance, which is
        not a time-tree parameter, and its logP DEGRADES to -24005.93
        (verified against libphyc)."""
        import re

        cfg = os.path.join(data_dir, "jc69-time.json")
        out = subprocess.run(
            [sys.executable, "-m", "physher_tpu.cli", cfg],
            capture_output=True, text=True, timeout=240,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert out.returncode == 0, out.stderr[-2000:]
        m = re.search(r"Maximum log likelihood: (-?\d+\.\d+)", out.stdout)
        assert m, out.stdout[-2000:]
        assert abs(float(m.group(1)) - (-4341.059554)) <= 1e-3
