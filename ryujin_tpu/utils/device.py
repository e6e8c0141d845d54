"""The device a measurement runs on: identity, power limit and peaks.

Importing this module does not import JAX, so `query_nvidia_smi` can run
before the process first touches the card.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict

# Published peaks per `jax.devices()[0].device_kind`.  A measurement on a
# device that is not listed is an error, not a default.
PEAKS: Dict[str, Dict] = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67.0e12,  # outside the tensor cores
        "fp64_flops": 34.0e12,  # outside the tensor cores
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, "
                  "dense rates at the 700 W limit",
    },
}


def query_nvidia_smi() -> str:
    """`name, power.limit` of each card as nvidia-smi prints them, or a
    note saying why it could not be read."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip()


def device_record() -> Dict:
    """platform, device_kind and count of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> Dict:
    """The device record; raises unless JAX's default platform is a GPU
    (a measurement never falls back to the CPU)."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default platform is {rec['platform']!r} "
            f"({rec['kind']})"
        )
    return rec


def peaks(device_kind: str) -> Dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it "
            f"to ryujin_tpu.utils.device.PEAKS with its source"
        ) from None
