"""Verification baselines on a GPU (marker `gpu`).

tests/conftest.py pins the suite to the CPU, so these skip under pytest;
`python3 chip_smoke.py` runs the same phase functions on the card.
"""

import jax
import pytest

import chip_smoke


@pytest.fixture
def gpu():
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU; python3 chip_smoke.py runs this check "
                    "on the card")
    with jax.default_device(devices[0]):
        yield devices[0]


@pytest.mark.gpu
def test_vortex_f64_within_1pct_of_double_baseline(gpu):
    chip_smoke.phase_vortex_f64()


@pytest.mark.gpu
@pytest.mark.parametrize("level", [6, 7, 8])
def test_vortex_f32_within_float_baseline_bands(gpu, level):
    chip_smoke.phase_vortex_f32(levels=(level,))


@pytest.mark.gpu
def test_shallow_water_vortex_f32_within_5pct(gpu):
    chip_smoke.phase_sw_vortex_f32()


@pytest.mark.gpu
def test_gpu_f64_matches_cpu_f64(gpu):
    chip_smoke.phase_gpu_vs_cpu()
