"""Tracing, timing, and roofline accounting.

The reference has no in-library profiling — only wall-clock totals
(reference: src/physher.c:320-324) and the benchmark harness's
clock_gettime loops (examples/benchmarking.c:17-20). This module is the
observability layer SURVEY.md §5 calls for: jax.profiler trace capture
and its reduction to device busy time, op counts and idle share,
steady-state timing with compile-time separation, and a roofline model for
the pruning sweep against the device's published peaks.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclass
class Timing:
    compile_s: float
    per_call_s: float
    calls: int

    @property
    def per_call_ms(self) -> float:
        return self.per_call_s * 1e3


def time_jit(fn, *args, calls: int = 20, warmup: int = 2) -> Timing:
    """Steady-state timing of a jitted callable: first call (compile)
    separated from the amortized per-call time."""
    import jax

    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn(*args)
    jax.block_until_ready(out)
    return Timing(compile_s, (time.perf_counter() - t0) / calls, calls)


# A GPU trace (jax.profiler, CUPTI) has one plane per card, named
# "/device:GPU:<n>", and one line per CUDA stream, named "Stream #<id>(<the
# kinds of work on it>)"; its events are the kernels and copies as launched.
DEVICE_PLANE_PREFIX = "/device:GPU:"
STREAM_LINE_PREFIX = "Stream #"


@dataclass
class DeviceOps:
    """Device-side activity of a traced window (all device planes)."""
    busy_s: float      # union of op intervals, summed over devices
    window_s: float    # first op start to last op end, per device, summed
    n_ops: int         # kernels and copies launched
    rows: list         # [(op_name, seconds, count)] by time, top-N

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s if self.window_s else 0.0


def device_ops(planes, top: int = 20) -> DeviceOps:
    """Reduce a trace's planes (``jax.profiler.ProfileData(...).planes`` or
    any objects with the same ``name``/``lines``/``events`` attributes) to
    device busy time, window, op count and the top ops. Raises when the
    trace has no device op track."""
    import collections

    agg = collections.Counter()
    cnt = collections.Counter()
    busy = window = 0.0
    n_ops = 0
    found = False
    for plane in planes:
        if not plane.name.startswith(DEVICE_PLANE_PREFIX):
            continue
        spans = []
        for line in plane.lines:
            if not line.name.startswith(STREAM_LINE_PREFIX):
                continue
            found = True
            for e in line.events:
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
                agg[e.name] += e.duration_ns
                cnt[e.name] += 1
        if not spans:
            continue
        spans.sort()
        n_ops += len(spans)
        window += spans[-1][1] - spans[0][0]
        cur_lo, cur_hi = spans[0]
        for lo, hi in spans[1:]:
            if lo > cur_hi:
                busy += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        busy += cur_hi - cur_lo
    if not found:
        raise RuntimeError(
            f"no device op track ({DEVICE_PLANE_PREFIX}* plane with "
            f"{STREAM_LINE_PREFIX}* lines) in the trace")
    rows = [(name, ns / 1e9, cnt[name]) for name, ns in agg.most_common(top)]
    return DeviceOps(busy / 1e9, window / 1e9, n_ops, rows)


def trace_op_times(fn, args_seq, *, log_dir: str, top: int = 20) -> DeviceOps:
    """MEASURED device-op timing: run ``fn`` over ``args_seq`` (a sequence
    of argument tuples — perturb inputs between calls so nothing is served
    from an execution cache) under a jax.profiler trace written to
    ``log_dir``, and reduce the device planes with :func:`device_ops`.
    Totals cover ALL calls — divide by ``len(args_seq)`` for per-call."""
    import glob
    import os
    import shutil

    import jax

    shutil.rmtree(log_dir, ignore_errors=True)
    out = fn(*args_seq[0])
    jax.block_until_ready(out)           # compile outside the trace
    jax.profiler.start_trace(log_dir)
    try:
        for args in args_seq:
            out = fn(*args)
        jax.block_until_ready(out)
    finally:
        jax.profiler.stop_trace()

    paths = glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb"))
    if not paths:
        raise RuntimeError(f"no trace written under {log_dir}")
    data = jax.profiler.ProfileData.from_file(
        max(paths, key=os.path.getmtime))
    return device_ops(data.planes, top=top)


# -- roofline ---------------------------------------------------------------

# Published peaks per device, keyed by jax's ``device_kind``: dense rates
# outside the tensor cores (the pruning's 4..61-state contractions run at
# full f32 or f64 precision) and device-memory bandwidth. Source: NVIDIA
# H100 data sheet (SXM5 and PCIe parts; rates at the full power limit).
CHIP_PEAKS = {
    # device_kind: {f32 TFLOP/s, f64 TFLOP/s, memory GB/s}
    "NVIDIA H100 80GB HBM3": {"f32": 67.0, "f64": 34.0, "gb_s": 3350.0},
    "NVIDIA H100 PCIe": {"f32": 51.0, "f64": 26.0, "gb_s": 2000.0},
}


def chip_peaks(chip: str) -> dict:
    if chip not in CHIP_PEAKS:
        raise ValueError(f"no published peaks for device {chip!r}; "
                         f"known: {sorted(CHIP_PEAKS)}")
    return CHIP_PEAKS[chip]


@dataclass
class Roofline:
    flops: float
    bytes: float
    seconds: float
    chip: str
    dtype_bytes: int = 4
    notes: dict = field(default_factory=dict)

    def __post_init__(self):
        chip_peaks(self.chip)

    @property
    def peaks(self) -> tuple:
        """(peak TFLOP/s at this precision, peak memory GB/s)."""
        p = chip_peaks(self.chip)
        return p["f64" if self.dtype_bytes == 8 else "f32"], p["gb_s"]

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, FLOPs/byte."""
        return self.flops / max(self.bytes, 1.0)

    @property
    def achieved_tflops(self) -> float:
        return self.flops / max(self.seconds, 1e-12) / 1e12

    @property
    def achieved_gbs(self) -> float:
        return self.bytes / max(self.seconds, 1e-12) / 1e9

    def bound(self) -> str:
        peak_tf, peak_bw = self.peaks
        ridge = peak_tf * 1e12 / (peak_bw * 1e9)
        return "compute" if self.intensity > ridge else "memory"

    def fraction_of_peak(self) -> float:
        peak_tf, peak_bw = self.peaks
        if self.bound() == "compute":
            return self.achieved_tflops / peak_tf
        return self.achieved_gbs / peak_bw

    def report(self) -> str:
        frac = self.fraction_of_peak()
        # with both roofs far away the limiting-roof label misleads:
        # the kernel is really bound by per-op latency / occupancy, not
        # the roof it happens to sit under
        bound = (self.bound() if frac >= 0.3
                 else f"{self.bound()}-roof, latency/occupancy")
        return (f"{self.flops/1e9:.2f} GFLOP, {self.bytes/1e6:.1f} MB, "
                f"{self.seconds*1e3:.3f} ms -> "
                f"{self.achieved_tflops:.2f} TFLOP/s, "
                f"{self.achieved_gbs:.1f} GB/s "
                f"({bound}-bound, "
                f"{100*frac:.1f}% of peak on "
                f"{self.chip})")


def pruning_roofline(n_nodes: int, n_cat: int, n_states: int,
                     n_patterns: int, seconds: float, *, chip: str,
                     dtype_bytes: int = 4,
                     with_gradient: bool = False) -> Roofline:
    """Roofline model of one likelihood evaluation.

    FLOPs: per internal node, per category: S x S x P multiply-adds per
    child (x2 children) plus the S x P product — the arithmetic the
    reference's SIMD kernels perform (treelikelihood4.c update_partials).
    Bytes: partials read/write + P-matrices, the device-memory floor of
    the level-batched XLA path.
    """
    internal = n_nodes // 2
    flops = internal * n_cat * (2 * 2 * n_states * n_states * n_patterns
                                + n_states * n_patterns)
    byts = (n_nodes * n_cat * n_states * n_patterns * 2      # partials rw
            + n_nodes * n_cat * n_states * n_states) * dtype_bytes
    if with_gradient:
        flops *= 3
        byts *= 2
    return Roofline(float(flops), float(byts), seconds, chip, dtype_bytes)


def detect_chip() -> str:
    """The default device's ``device_kind``, if :data:`CHIP_PEAKS` knows it;
    any other device is an error, not a default."""
    import jax

    kind = jax.devices()[0].device_kind
    chip_peaks(kind)
    return kind
