"""Configuration files: the in-repo YAML subset reader and writer.

The shipped benchmark configs load without any YAML library, survive
save -> load unchanged, and anything outside the subset is refused.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from ryujin_tpu.config import Config
from ryujin_tpu.utils import yaml_subset

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs" / "benchmarks").glob("*.yaml"))


def test_all_benchmark_configs_found():
    assert len(CONFIGS) == 7


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_shipped_config_round_trips(path, tmp_path):
    cfg = Config.load(str(path))
    out = tmp_path / "saved.yaml"
    cfg.save(str(out))
    cfg2 = Config.load(str(out))
    assert cfg2.dumps() == cfg.dumps()
    # every value the file sets reaches the Config unchanged:
    raw = yaml_subset.load(path.read_text())
    full = cfg.to_dict()
    for section, values in raw.items():
        if isinstance(values, dict):
            for key, v in values.items():
                assert full[section][key] == v, (section, key)
        else:
            assert full[section] == values, section


def test_step_config_literal():
    raw = yaml_subset.load(
        (ROOT / "configs/benchmarks/euler-mach3-forward-facing-step.yaml")
        .read_text()
    )
    assert raw == {
        "time_loop": {
            "basename": "mach3-step",
            "enable_output_full": True,
            "final_time": 4.0,
            "timer_granularity": 0.1,
        },
        "equation": {
            "dimension": 2,
            "equation": "euler",
            "parameters": {"gamma": 1.4},
        },
        "discretization": {"geometry": "step", "mesh_refinement": 3},
        "initial_values": {
            "configuration": "uniform",
            "direction": [1, 0],
            "position": [1, 0],
            "parameters": {"primitive_state": [1.4, 3.0, 1.0]},
        },
        "time_integrator": {
            "cfl_min": 0.9,
            "cfl_max": 0.9,
            "cfl_recovery_strategy": "none",
            "time_stepping_scheme": "erk 33",
        },
        "vtu_output": {
            "schlieren_beta": 10,
            "schlieren_quantities": ["rho"],
        },
    }


def test_exponent_floats_are_numbers():
    """`1.0e4` (no exponent sign) is a float under the YAML 1.2 core
    schema; a YAML 1.1 reader returns the string '1.0e4', which the
    shallow-water equation cannot multiply."""
    from ryujin_tpu.equations.dispatch import make_equation

    cfg = Config.load(
        str(ROOT / "configs/benchmarks/shallow_water-G3-S2-experiment.yaml")
    )
    p = cfg.equation.parameters
    assert p["dry_state_relaxation_small"] == 1.0e4
    assert isinstance(p["dry_state_relaxation_large"], float)
    eq = make_equation(cfg.equation)
    assert eq.params.dry_state_relaxation_small == 1.0e4


@pytest.mark.parametrize("text,expected", [
    ("a: 1\nb: -2.5\nc: 1e-3\nd: .inf\ne: ~\nf: true\ng: erk 33\n",
     {"a": 1, "b": -2.5, "c": 1e-3, "d": float("inf"), "e": None,
      "f": True, "g": "erk 33"}),
    ("a: [1, [2, 3], {k: 'x y'}]  # comment\n",
     {"a": [1, [2, 3], {"k": "x y"}]}),
    ("a:\n  - [m, \"-x\"]\n  - [n, \"1.0\"]\n",
     {"a": [["m", "-x"], ["n", "1.0"]]}),
    ("a:\n- 1\n- two\nb: \"q # not a comment\"\n",
     {"a": [1, "two"], "b": "q # not a comment"}),
])
def test_subset_reads(text, expected):
    assert yaml_subset.load(text) == expected


@pytest.mark.parametrize("text", [
    "a: &anchor 1\n",
    "a: *alias\n",
    "a: !!str 1\n",
    "a: |\n  block\n",
    "---\na: 1\n",
    "a: [1, 2\n",
    "- k: v\n",
    "a: 1\na: 2\n",
    "a:\n\tb: 1\n",
])
def test_subset_refuses(text):
    with pytest.raises(yaml_subset.YamlSubsetError):
        yaml_subset.load(text)


def test_writer_round_trips_awkward_strings():
    d = {"s": ["-x", "1.0", "true", "a: b", "x**2 + y**2", "", "null",
               "tab\there"],
         "f": [1e-12, 1e16, -0.0, 3.0], "e": {}, "n": None}
    assert yaml_subset.load(yaml_subset.dump(d)) == d


def test_pallas_backend_refused():
    with pytest.raises(ValueError, match="removed"):
        Config.from_dict({"backend": "pallas"})
    with pytest.raises(ValueError, match="precision"):
        Config.from_dict({"precision": "float16"})
    assert Config.from_dict({"backend": "xla"}).backend == "xla"


def test_package_imports_without_pyyaml():
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import ryujin_tpu.driver, ryujin_tpu.__main__\n"
        "from ryujin_tpu.config import Config\n"
        f"Config.load({str(CONFIGS[0])!r})\n"
        "print('ok')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
