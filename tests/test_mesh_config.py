"""Multi-device runs through the config/product surface.

BASELINE workload #5 (multi-host MCMC + path-sampling marginal with
patterns sharded across devices) expressed via the config layer: a
``devices``/``mesh`` declaration builds a ``jax.sharding.Mesh``, shards
every TreeLikelihood's pattern constants (the reference's SIMD/OpenMP
pattern axis, src/phyc/treelikelihood.c:1426-1452 -> mesh data axis; the
weighted-root-sum reduction point at treelikelihood.c:1483-1486 becomes a
psum), and the MCMC/ladder drivers place chains on the mesh's chain axis
(the reference runs chains/ladders sequentially, mcmc.c:60-185 /
mmcmc.c:48-88).

Runs on the conftest's virtual 8-device CPU mesh in f64, so sharded
results are asserted (nearly) EXACTLY equal to single-device runs — the
same seed drives identical proposal streams and f64 reductions.
"""

import copy

import jax
import numpy as np
import pytest

from physher_tpu.config.actions import Runner
from physher_tpu.config.builder import build_config, load_json


@pytest.fixture(scope="module")
def cfg(data_dir):
    return load_json(f"{data_dir}/jc69-time.json")


def _mcmc_actions(length=48, every=8):
    return [{"type": "mcmc", "id": "mc", "model": "&treelikelihood",
             "length": length, "log": [{"every": every}]}]


def test_config_mesh_builds_and_shards(cfg, data_dir):
    ctx, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir,
                          devices={"chains": 2, "patterns": 4})
    assert ctx.mesh is not None
    assert dict(ctx.mesh.shape) == {"chains": 2, "patterns": 4}
    tlk = ctx.objects["treelikelihood"]
    assert tlk.mesh is ctx.mesh
    assert tlk.tip_partials.shape[-1] % 4 == 0

    # sharded logP == single-device logP (exact reduction, f64)
    ctx1, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir)
    tlk1 = ctx1.objects["treelikelihood"]
    p = tlk1.param_space().init_params()
    l1 = float(jax.jit(tlk1.log_likelihood)(p))
    lN = float(jax.jit(tlk.log_likelihood)(p))
    np.testing.assert_allclose(lN, l1, rtol=1e-12)


def test_init_devices_key(cfg, data_dir):
    c = copy.deepcopy(cfg)
    c["init"] = {"seed": 3, "devices": 4}
    ctx, _ = build_config(c, base_dir=data_dir)
    assert dict(ctx.mesh.shape) == {"patterns": 4}
    assert ctx.seed == 3


def test_action_mcmc_on_mesh_matches_single_device(cfg, data_dir):
    """action_mcmc end-to-end on a 2x4 chains x patterns mesh: same seed
    -> same samples as the single-device run (f64, exact kernels)."""
    ctx1, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir)
    r1 = Runner(ctx1, seed=7)
    res1 = r1.action_mcmc(dict(_mcmc_actions()[0], chains=2))

    ctxN, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir,
                           devices={"chains": 2, "patterns": 4})
    rN = Runner(ctxN, seed=7)
    resN = rN.action_mcmc(_mcmc_actions()[0])

    assert resN.samples_u.shape == res1.samples_u.shape  # [S, 2, dim]
    np.testing.assert_allclose(resN.samples_u, res1.samples_u,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(resN.log_posterior, res1.log_posterior,
                               rtol=1e-9)


def test_action_mmcmc_path_sampling_on_mesh(cfg, data_dir):
    """Tempered ladder + path-sampling/stepping-stone marginal through the
    config surface on the mesh (workload #5), matching single-device."""
    from physher_tpu.inference import marginal as marg

    action = {"type": "mmcmc", "id": "ml", "model": "&treelikelihood",
              "temperatures": 4, "length": 40, "every": 8, "burnin": 8}

    outs = []
    for devices in (None, {"chains": 2, "patterns": 4}):
        ctx, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir,
                              devices=devices)
        r = Runner(ctx, seed=11)
        temps, lls, _ = r.action_mmcmc(dict(action))
        ss, _ = marg.log_stepping_stone(lls, temps)
        ps, _ = marg.log_path_sampling(lls, temps)
        assert np.isfinite(ss) and np.isfinite(ps)
        outs.append((np.asarray(temps), np.stack(lls), ss, ps))

    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-9)
    np.testing.assert_allclose(outs[1][2], outs[0][2], rtol=1e-9)
    np.testing.assert_allclose(outs[1][3], outs[0][3], rtol=1e-9)


def test_action_vb_fit_on_mesh_matches_single_device(data_dir):
    """Variational fit (action_optimizer on a VariationalHandle) sharded
    over the mesh == single-device: same seed -> same sample stream ->
    same ELBO trajectory (round-4 review ask: mesh-aware VB; BASELINE
    workload #5 for the VI family)."""
    base = load_json(f"{data_dir}/fluA-elbo.json")
    elbos = []
    for devices in (None, {"chains": 1, "patterns": 4}):
        ctx, actions = build_config(copy.deepcopy(base), base_dir=data_dir,
                                    devices=devices)
        r = Runner(ctx, seed=5)
        node = dict(actions[0], max=40, tol=0.0)
        node.pop("checkpoint", None)
        res = r.action_optimizer(node)
        elbos.append(res.elbo)
        assert np.isfinite(res.elbo)
    np.testing.assert_allclose(elbos[1], elbos[0], rtol=1e-9)


def test_action_ml_optimize_on_mesh_matches_single_device(cfg, data_dir):
    """Adam ML optimization through the config surface sharded over the
    mesh == single-device (round-4 review ask: mesh-aware ML)."""
    node = {"type": "optimizer", "algorithm": "adam", "max": 60,
            "model": "&treelikelihood", "precision": 0.0}
    logps = []
    for devices in (None, {"chains": 1, "patterns": 4}):
        ctx, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir,
                              devices=devices)
        r = Runner(ctx, seed=5)
        res = r.action_optimizer(dict(node))
        logps.append(res.logp)
        assert np.isfinite(res.logp)
    np.testing.assert_allclose(logps[1], logps[0], rtol=1e-9)


def test_cli_devices_flag(cfg, data_dir, tmp_path, capsys):
    """--devices through the physher-tpu CLI entry point."""
    import json

    from physher_tpu.cli import main

    c = copy.deepcopy(cfg)
    c["physher"] = _mcmc_actions(length=16, every=8)
    f = tmp_path / "cfg.json"
    # the config references fluA.fa relative to tests/data
    f.write_text(json.dumps(c).replace("fluA.fa", f"{data_dir}/fluA.fa"))
    assert main([str(f), "--devices", "4", "--platform", "cpu"]) == 0
    assert "MCMC finished" in capsys.readouterr().out


@pytest.mark.parametrize("devices,want", [(None, 238), (4, 240), (8, 240)])
def test_pattern_padding_is_mesh_size(cfg, data_dir, devices, want):
    """fluA's 238 patterns: no padding on one device, padded (with zero
    weight) to a multiple of the pattern-mesh size when sharded."""
    ctx, _ = build_config(copy.deepcopy(cfg), base_dir=data_dir,
                          devices=devices)
    tlk = ctx.objects["treelikelihood"]
    assert tlk.tip_partials.shape[-1] == want
    assert float(np.sum(np.asarray(tlk.weights)[238:])) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_default_pattern_padding_is_none(data_dir, dtype):
    from physher_tpu.data.sitepattern import SitePattern
    from physher_tpu.io.seqio import read_alignment
    from physher_tpu.models.substitution import JC69
    from physher_tpu.models.treelikelihood import TreeLikelihood
    from physher_tpu.utils.synthetic import balanced_topology

    sp = SitePattern.from_alignment(read_alignment(f"{data_dir}/fluA.fa"))
    topo = balanced_topology(69)
    topo.taxa[:] = sp.taxa
    tlk = TreeLikelihood(sp, topo, JC69(), dtype=np.dtype(dtype))
    assert tlk.tip_partials.shape[-1] == sp.pattern_count == 238
