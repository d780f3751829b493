"""Entry-point plumbing for running on the card: compile-cache placement,
chip_smoke's device check and result line, the benchmark's peak table and
trace lanes, and the CLI's --platform choices."""
import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest

import bench
import chip_smoke
from tpuslam.cli.main import build_parser
from tpuslam.runtime import device

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(ROOT / ".jax_cache")
    assert device.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_chip_smoke_refuses_cpu_only_process():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""            # no result line, no phase ran
    assert "no GPU" in proc.stderr


def test_chip_smoke_result_line_has_contract_keys():
    line = chip_smoke.result_line({"platform": "gpu",
                                   "kind": "NVIDIA H100 80GB HBM3",
                                   "count": 1, "extra": "dropped"})
    rec = json.loads(line)
    assert rec == {"ok": True, "device": {"platform": "gpu",
                                          "kind": "NVIDIA H100 80GB HBM3",
                                          "count": 1}}
    assert "\n" not in line


def test_peak_table_resolves_h100():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["f32_flops"] == 67e12
    assert peaks["bf16_flops"] == 989e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12


def test_peak_table_rejects_unknown_kind():
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks("cpu")


def test_trace_lanes_pick_gpu_ops_only():
    meta = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 7,
         "args": {"name": "python"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 1,
         "args": {"name": "XLA Modules"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 2,
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 3,
         "args": {"name": "Stream #13(Compute)"}},
    ]
    assert bench.device_op_lanes(meta) == {(2, 2)}
    no_ops = [e for e in meta if e.get("tid") != 2]
    assert bench.device_op_lanes(no_ops) == {(2, 3)}


def test_platform_flag_accepts_gpu():
    args = build_parser().parse_args(["--platform", "gpu", "msc"])
    assert args.platform == "gpu"


def test_platform_flag_rejects_tpu(capsys):
    with pytest.raises(SystemExit) as e:
        build_parser().parse_args(["--platform", "tpu", "msc"])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
