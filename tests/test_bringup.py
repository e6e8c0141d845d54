"""What the GPU run depends on, checked on the CPU.

Compile-cache placement, float64 honoured by TimeLoop, the device and
peak table, and chip_smoke.py's phases at tiny size (the full-size run
needs a GPU: `python3 chip_smoke.py`).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from ryujin_tpu.utils import compile_cache, device

ROOT = Path(__file__).resolve().parents[1]


def _python(code, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu")
    e.pop("XLA_FLAGS", None)
    e.pop(compile_cache.ENV_VAR, None)
    e.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=e,
                          capture_output=True, text=True, timeout=600)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_compile_cache_default_is_fixed_ignored_dir():
    out = _python(
        "import jax\n"
        "from ryujin_tpu.utils.compile_cache import configure_compile_cache\n"
        "print(configure_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()
    assert returned == configured == str(ROOT / ".jax_cache")
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_precision_float64_gives_float64_state(tmp_path):
    """A fresh process without 64-bit mode: TimeLoop must switch it on
    for precision float64 (and leave float32 runs in float32)."""
    out = _python(
        "import jax, jax.numpy as jnp\n"
        "from ryujin_tpu.config import Config\n"
        "from ryujin_tpu.driver import TimeLoop\n"
        "from ryujin_tpu.postprocess.error import interpolate_nodal\n"
        "for prec in ('float32', 'float64'):\n"
        "    cfg = Config()\n"
        "    cfg.precision = prec\n"
        "    cfg.discretization.mesh_refinement = 2\n"
        f"    cfg.time_loop.basename = {str(tmp_path / 'p')!r}\n"
        "    loop = TimeLoop(cfg)\n"
        "    U = interpolate_nodal(loop.initial_state_fn, loop.packed,\n"
        "                          loop.eq, 0.0, loop.dtype)\n"
        "    out = loop.time_integrator.advance(U, 0.0, 1)\n"
        "    print(prec, out[0].dtype, out[2].dtype)\n"
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert "float32 float32 float32" in lines
    assert "float64 float64 float64" in lines


def test_peak_table_refuses_unknown_device():
    h100 = device.peaks("NVIDIA H100 80GB HBM3")
    assert h100["hbm_bytes_per_s"] == 3.35e12 and h100["source"]
    with pytest.raises(KeyError, match="no published peaks"):
        device.peaks("NVIDIA A100-SXM4-40GB")


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_chip_smoke_device_check_refuses_cpu():
    with pytest.raises(chip_smoke.PhaseFailure, match="no GPU"):
        chip_smoke.check_device(device.device_record())
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 JAX_COMPILATION_CACHE_DIR=str(ROOT / ".jax_cache")),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 2
    last = out.stdout.strip().splitlines()[-1]
    with pytest.raises(json.JSONDecodeError):
        json.loads(last)
    assert "no GPU" in out.stderr


def test_chip_smoke_time_loop_phase_tiny():
    r = chip_smoke.phase_time_loop(
        chip_smoke.STEP_CONFIG, "float64", 16, chunk=16, refinement=0,
        label="step", expect_layout="StructuredData",
    )
    assert r["n_nodes"] == 16449 and r["mqs"] > 0


def test_chip_smoke_ell_phase_tiny():
    r = chip_smoke.phase_time_loop(
        chip_smoke.CYLINDER_3D_CONFIG, "float64", 8, chunk=8,
        refinement=0, label="ell-3d", run_check=False,
        expect_layout="EllData",
    )
    assert r["layout"] == "EllData"


def test_chip_smoke_reference_phase_tiny():
    """On the CPU the 'device' and the reference are the same backend,
    so the two runs agree exactly."""
    assert chip_smoke.phase_gpu_vs_cpu(refinement=0, n_steps=2) == 0.0


@pytest.mark.parametrize("problem,dtype", [
    ("vortex", "float32"), ("vortex", "float64"), ("sw-vortex", "float32"),
])
def test_chip_smoke_verification_problems_tiny(problem, dtype):
    errs = chip_smoke.verification_errors(problem, 3, dtype)
    assert np.isfinite(errs).all() and 0 < errs[1] < 1.0
