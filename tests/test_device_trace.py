"""Device-trace reduction (utils/profiling.device_ops) on canned GPU-shaped
traces, and the per-device roofline peaks."""

from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import pytest

from physher_tpu.utils import profiling

H100 = "NVIDIA H100 80GB HBM3"


def ev(name, start, dur):
    return NS(name=name, start_ns=start, duration_ns=dur)


def gpu_plane(n, streams):
    return NS(name=f"/device:GPU:{n}", lines=[
        NS(name=name, events=events) for name, events in streams])


HOST = NS(name="/host:CPU", lines=[
    NS(name="python", events=[ev("$profiler.py start_trace", 0, 10**9)])])


def test_device_ops_one_gpu():
    plane = gpu_plane(0, [
        ("Stream #13(MemcpyD2H,Compute,MemcpyH2D,MemcpyD2D)", [
            ev("loop_multiply_fusion", 1000, 200),
            ev("input_reduce_fusion", 1300, 100),
            ev("loop_multiply_fusion", 1500, 300)]),
        ("Stream #14(MemcpyH2D)", [ev("MemcpyH2D", 1350, 200)]),
    ])
    ops = profiling.device_ops([HOST, plane])
    assert ops.n_ops == 4
    # union: [1000,1200] + [1300,1550] + [1500,1800] -> 200 + 500
    assert ops.busy_s == pytest.approx(700e-9)
    assert ops.window_s == pytest.approx(800e-9)
    assert ops.idle_share == pytest.approx(1 - 700 / 800)
    assert ops.rows[0] == ("loop_multiply_fusion", pytest.approx(500e-9), 2)


def test_device_ops_sums_devices():
    planes = [gpu_plane(i, [("Stream #7(Compute)", [ev("k", 100 * i, 50)])])
              for i in range(4)]
    ops = profiling.device_ops(planes)
    assert ops.n_ops == 4
    assert ops.busy_s == pytest.approx(200e-9)
    assert ops.idle_share == pytest.approx(0.0)


def test_device_ops_raises_without_device_track():
    with pytest.raises(RuntimeError, match="no device op track"):
        profiling.device_ops([HOST])
    # a device plane whose lines are not streams is not a device op track
    with pytest.raises(RuntimeError, match="no device op track"):
        profiling.device_ops([gpu_plane(0, [("XLA Modules", [])])])


def test_trace_op_times_on_cpu_raises(tmp_path):
    """A real trace on this CPU has no GPU plane: an error, not (0, [])."""
    f = jax.jit(lambda x: jnp.sin(x).sum())
    with pytest.raises(RuntimeError, match="no device op track"):
        profiling.trace_op_times(f, [(jnp.ones(64),), (jnp.ones(64) * 2,)],
                                 log_dir=str(tmp_path / "trace"))


def test_roofline_unknown_device_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        profiling.Roofline(1.0, 1.0, 1.0, "Unknown Accelerator 9")
    with pytest.raises(ValueError):
        profiling.pruning_roofline(137, 4, 4, 256, 1e-3, chip="cpu")


@pytest.mark.parametrize("dtype_bytes,peak", [(4, 67.0), (8, 34.0)])
def test_roofline_peak_follows_precision(dtype_bytes, peak):
    r = profiling.pruning_roofline(255, 4, 4, 16384, 1e-3, chip=H100,
                                   dtype_bytes=dtype_bytes)
    assert r.peaks == (peak, 3350.0)
    assert r.bound() == "memory"
    assert H100 in r.report()
