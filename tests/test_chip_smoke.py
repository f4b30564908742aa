"""The pure pieces of chip_smoke.py, on the CPU: the device check refuses a
CPU, the nvidia-smi line parses, --four-gpus selects only its phase."""

import os
import sys
from types import SimpleNamespace

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def _gpus(n):
    return [SimpleNamespace(platform="gpu",
                            device_kind="NVIDIA H100 80GB HBM3")] * n


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())


@pytest.mark.parametrize("have,need,ok", [(1, 1, True), (4, 4, True),
                                          (1, 4, False), (0, 1, False)])
def test_require_gpu_counts(have, need, ok):
    if ok:
        chip_smoke.require_gpu(_gpus(have), need)
    else:
        with pytest.raises(RuntimeError):
            chip_smoke.require_gpu(_gpus(have), need)


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 400.00 W\n",
     ("NVIDIA H100 80GB HBM3", "400.00 W")),
    ("NVIDIA H100 PCIe, 350.00 W", ("NVIDIA H100 PCIe", "350.00 W")),
    ("NVIDIA H100 80GB HBM3, [N/A]", ("NVIDIA H100 80GB HBM3", "[N/A]")),
])
def test_parse_smi_line(line, want):
    assert chip_smoke.parse_smi_line(line) == want


@pytest.mark.parametrize("line", ["", "NVIDIA H100 80GB HBM3", ", 400 W"])
def test_parse_smi_line_rejects(line):
    with pytest.raises(ValueError):
        chip_smoke.parse_smi_line(line)


@pytest.mark.parametrize("argv,want", [
    ([], ("device", "f64_goldens", "f32", "config", "samplers")),
    (["--four-gpus"], ("four_gpus",)),
])
def test_select_phases(argv, want):
    assert chip_smoke.select_phases(chip_smoke.parse_args(argv)) == want
    assert all(hasattr(chip_smoke.Smoke, name) for name in want)


def test_main_on_cpu_fails_without_result(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_cache_entries(tmp_path):
    assert chip_smoke.cache_entries(None) == 0
    assert chip_smoke.cache_entries(str(tmp_path / "missing")) == 0
    (tmp_path / "a").write_text("x")
    assert chip_smoke.cache_entries(str(tmp_path)) == 1
