import os

# Run the test-suite on a virtual 8-device CPU mesh: multi-device sharding
# is validated without accelerators, and CPU float64 is available for
# verification runs.  Every test is pinned to the CPU (jax.config.update is
# authoritative over JAX_PLATFORMS); tests marked `gpu` skip here, and
# chip_smoke.py runs the same checks on the card.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
